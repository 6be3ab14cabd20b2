#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build       compile the CUDA kernels from ``hyperopt_tpu_torch/csrc``
               (one ``nvcc`` per source, started together): K1 (f32) and
               K2 (bf16) in ``ei_scores.cu``, K3 (tensor cores) in
               ``ei_scores_mxu.cu``, the lanes' draw in
               ``lane_uniforms.cu``, the split sets' weights in
               ``set_weights.cu``.
2. ei_kernel   hold each kernel against its plain PyTorch version on the
               card at the TPE step's shape (31 columns x 10,000 candidates
               x (26 + 1025) components), at the 2,048 bucket's shape
               (26 + 2049, a live prefix of 1,030 above) and at edge
               shapes, with extreme values, a dead tail and dead
               components scattered through the staged chunks; time the
               kernels at both step shapes and the plain version at the
               first.  Then ``lane_uniforms``: the one-launch draw of 1
               and 64 lanes' uniforms (flagship space, 10,000
               candidates) against ``torch.rand``'s sheets bit for bit
               and against its plain twin, timed beside its bound (the
               bytes it writes), the twin, and the per-lane
               ``torch.rand`` calls and stacks it replaces, eager and
               replayed from a graph with their generators registered.
               Then ``set_weights``: both split sets' weights of one
               column group at the hosted (1 x 1,024 x 31) and the fleet
               (64 x 1,024 x 31) shapes against the twin bit for bit,
               timed beside its bound (the bytes it moves) and the twin
               (the ``torch.cumsum`` composition it replaces), eager and
               replayed from a graph.
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
8. obs         the observability layer at the same width (1,000 trials
               from empty, bucket 1,024): (a) solo device mode with the
               telemetry slab armed and disarmed at strides None and 8:
               identical trials and fetch counts, the slab's TPE steps
               (980) and best loss against the trials', card ms per replay
               (CUDA events, in turns) and kernels per replay (profiler)
               for each arm; (b) ``fmin_fleet`` at 8 lanes, armed: the
               slabs of lanes 0 and 7 equal their solo runs' slabs bit for
               bit; (c) a hosted ``fmin(trace_dir=)`` from the 1,000-trial
               history, 20 TPE steps: the three host artifacts and the
               profiler's export, which names the EI kernel once per TPE
               step; (d) the hosted step with the obs layer armed (metrics,
               events, cost ledger) and disarmed: host ms per step over
               the same steps, in turns, and the hooks' own time by
               cProfile.
9. pipeline    the pipelined loop and the pool at the same width, 64 trials
               after the 1,000-trial history with the objective plus a
               10 ms sleep: (a) serial, (b) ``overlap_suggest``, (c) depth
               2 x 2 evaluators, (d) depth 4 x 4, (e) depth 2 with batches
               of 8, (f) ``PoolTrials(4, "process")`` with CUDA live in
               this process, (g) a thread pool cut by ``fmin(timeout=)``.
               No trial is left NEW or RUNNING, no tid appears twice, the
               losses of (a)-(f) are finite; in (a)-(e) the EI kernel runs
               once per TPE step and no slot fails; (b) lands the trials
               of the depth-1 overlap loop written out inline; two depth-2
               runs with one evaluator land the same trials; each of (f)'s
               trials runs in a forked child; a warm dispatch and its copy
               to the host run under ``set_sync_debug_mode("error")``.
               Trials/s, occupancy, stalls, fetch waits and host ms per
               dispatch of each run.
10. tpe_rest    the rest of TPE at the same width: (a) the hosted joint
               step (``multivariate=True``): host ms, busy share and
               kernels beside the factorized step's, K1 once per step,
               card and CPU rows equal on a small step; (b) device mode,
               joint: 16 trials at stride 1 after the 1,000-trial history
               land the hosted joint run's, 256 from empty need one
               capture and run K1 once per replay (profiler), trials/s and
               card ms per replay beside the factorized step's, in turns;
               (c) per EI lowering, ``fmin_fleet(multivariate=True)`` over
               4 lanes lands each lane's solo run bit for bit, and a joint
               ``CohortScheduler`` serves 8 experiments with one launch,
               each row its solo ``tpe.suggest``'s; (d)
               ``comp_sampler="gumbel"`` captures, stays in bounds and
               its 4 fleet lanes equal their solo runs; card ms per
               replay of it and the default, in turns; (e)
               ``startup="qmc"``: the card's 20 startup rows equal the
               CPU's, device mode refuses it; (f) ``suggest_quantile``
               at ``overlap_depth=2`` runs K1 once per TPE step, and the
               host ms of the first step past the 1,024 bucket against a
               steady one, with and without the next bucket's kernel
               built ahead (``_prewarm_async``).
11. heads     the other suggest heads at the same width: (a) every
               registry name resolves, and ``fmin(algo="<name>")`` runs 16
               hosted trials after the 1,000-trial history for each unique
               head (rand, qmc, halton, tpe, tpe_quantile, tpe_sobol,
               tpe_mv, anneal, atpe, gp, es) and a mix of rand, gp and
               tpe: nothing left NEW or RUNNING, every value in bounds, K1
               once per TPE-family suggest and per ATPE pick and never for
               the others; (b) ATPE, 64 trials, each of its 8 arms forced
               once through the bandit state, and K1 against its plain
               version at 31 x 128, 256 and 512 candidates; (c) GP (64
               candidates, 256 rows fitted) and ES (8 per generation, 128
               generations): host ms and card ms per dispatch of 1 and 8
               proposals, a warm dispatch and its copy under
               ``set_sync_debug_mode("error")``, and card rows equal to
               CPU rows on the same draws at a small size; (d) anneal, a
               batch of 8 in one call, card rows equal to CPU rows on the
               same noise; (e) ``run_conformance`` for every unique head on
               the card, and ``fmin(overlap_depth=2)`` with gp and es.
12. dispatch  the dispatch substrate at the same width: (a)
               ``multihost.initialize()`` brings up a world-1 NCCL group
               and registers its ``(dp, sp) = (1, 1)`` CUDA mesh; (b) 16
               hosted trials after the 1,000-trial history through plain
               ``tpe.suggest`` under the mesh land the rows of 16 under
               ``dispatch.set_mode("local")`` bit for bit, with
               ``dispatch.sharded`` 16 and K1 16 times each; host ms per
               dispatch sharded against local, in turns; a warm sharded
               dispatch and its copy under ``set_sync_debug_mode("error")``;
               (c) K1, K2 and K3 on candidates ``[0, 5,000)`` and
               ``[5,000, 10,000)`` (and in 4 slices) equal the full launch
               bit for bit; (d) ``fmin_device(mesh=)``, 1,000 trials from
               empty: the unmeshed run's trials, no eager step, one capture
               with the all-gather inside, trials/s of both; ``n_runs=8``
               over dp = 1 equal to the unmeshed runs and runs 0 and 7 to
               their solo runs; (e) ``fmin_fleet(mesh=)`` over 8 lanes
               equal to the unmeshed fleet; (f) ``multi_start_suggest``
               with K = 8: 8 distinct in-bounds rows from one K1 launch over
               31·8 columns, ms per call; (g) ``multihost.run_driver`` over
               a ``FileTrials`` in a temporary directory with 2 worker
               processes: 84 trials DONE (64 after startup, each a sharded
               suggest with one K1 launch), no tid claimed twice, every
               worker exits 0; (h) a device-mode run with a
               ``TimeSeriesStore`` registered backfills windowed series,
               the registry's OpenMetrics text round-trips through the
               strict parser, the default SLOs evaluate.  The mesh is
               unregistered and the process group destroyed at the end.
13. contract  ``graft_entry_torch.py`` on the card: (a) ``entry()``'s
               step (the flagship space, 100 trials in the 128 bucket,
               1,024 candidates) eagerly, K1 once; (b) the same ``fn``
               captured in a CUDA graph (K1 recorded once) and replayed
               10 times, each replay's row and mask equal to the eager
               ones bit for bit, and K1 once per replay under the
               profiler; ms per replay against ms per eager step; (c) the
               card's row against the CPU's from the same uniforms: equal
               except where the two winners' EI gap is at most 1e-3; (d)
               ``dryrun_multichip(1)`` on a world-1 NCCL mesh: the sharded
               liar batch, multi-start, ``fmin_device(mesh=)`` and the
               global mesh, each equal to the local kernel's, and its
               ``mesh=``, ``trials evaluated`` and ``global mesh OK``
               lines.
14. netstore  the network store at the same width: (a) a token-protected
               ``StoreServer`` in a thread, the flagship domain published
               on cuda, the 1,000-trial history inserted and read back
               through ``NetTrials`` in binary frames; (b) 16
               ``server_suggest`` proposals (seeds 0-15) equal 16
               in-process ``tpe.suggest`` calls on the same history bit
               for bit, with exactly 16 K1 launches on the server side,
               and json mode gives the same docs; (c) every head of
               ``backends.names()``, plus ``tpe_bf16`` and ``tpe_mxu``
               registered by name, served once over the wire equals its
               in-process call (K2 and K3 once each); (d) host ms of a
               server-side round trip (and of the server's verb, the head
               inside it and the server store's refresh) against the
               in-process suggest, and of a full refresh of the 1,000
               docs in binary frames against JSON, medians of 10 in two
               turns; (e)
               ``multihost.run_driver`` over the server's URL with 2
               worker processes of the netstore's CLI: 84 trials DONE, no
               tid claimed twice, every worker exits 0, K1 once per
               post-startup suggest; (f) ``GET /metrics`` negotiated as
               OpenMetrics passes the strict parser.
15. service   the service tier at the same width: (a) a ``ServiceServer``
               in a thread (a table of 8 tenants, ``fsync="always"``, its
               WAL in a temporary directory, a 200 ms cohort window); each
               tenant publishes the flagship domain on cuda and inserts its
               own seeded 1,000-trial history in binary frames; (b) host ms
               of a server-side suggest on the RAM store against the
               in-process one (the gate detached), medians of 10 in two
               turns: rows equal bit for bit, one K1 launch each; (c) the
               8 tenants suggest concurrently, three windows in a row: each
               row equals its solo in-process row bit for bit, one fleet
               dispatch and one K1 launch (over 31·8 columns) per window;
               a 9th request with ``gamma=`` in a 4th window takes the solo
               path; (d) the server stops without a snapshot and a new one
               recovers the same ``state_bytes()`` from the WAL with no EI
               launch, then serves ``tpe_bf16`` and ``tpe_mxu`` by name
               (K2, K3 once each); (e) a ``Router`` over 2 ``ShardServer``
               primaries with a replica each: routed suggests equal the
               in-process ones, ``shard_add`` moves a store whose
               ``state_bytes()`` and next suggest are unchanged, and a
               primary shut down is failed over to its replica with no
               trial lost.
16. show      the port's ``show`` on the card's own artifacts, each step
               where the phase before it leaves them: (a) in obs (c),
               ``show trace`` over the hosted ``fmin(trace_dir=)`` from
               the 1,000-trial history (phases cover >= 95% of wall, the
               profiler export names K1) and ``--pickle`` of that run's
               trials (no torch object in the pickle); in the service
               phase (c) ``show live --once`` against the running
               ``ServiceServer`` after the cohort windows (every tenant's
               row and the cohort occupancy) and against the ``Router``
               (both shards ok); (d) ``show wal`` and ``--json`` over the
               service WAL (8 x 1,000 trials): ``per_verb`` equals the
               phase's own count of logged requests; (b) ``show trace
               --merge`` over the flight bundles pulled from the served
               run and the obs trace; (e) ``show bundle`` on one bundle;
               then (f) ``show lint --root`` on the checkout (the
               analyzers need only the stdlib): exit 0, 0 new.  Each
               step's wall time beside the card, and a ``show json:``
               line.
17. examples  every ``examples_torch/`` script on the card, in this
               process through ``runpy``, at its own budget and with no
               argument (06 only where scikit-learn is installed; the
               phase says so when it is not): each prints a result line
               with a finite number, and launches K1 (and neither K2 nor
               K3), counted from 0 just before it; 04's sharded run counts
               its 40 TPE steps in ``dispatch.sharded`` over a world-1
               NCCL mesh; 11 replays its captured step once per trial with
               no eager step.  Per script: wall seconds, best loss, K1
               launches, and for 11 the replays.
18. card_tests ``python -m pytest tests_torch_cuda`` in a subprocess: exit 0
               and every collected test passed.

A hosted one-proposal TPE step replays its kernel's CUDA graph after the
kernel's first step (``tpe._HostedStep``); the EI wrapper counts eager
launches and launches recorded into graphs, not replays.  Each phase
keeps the three apart (:func:`check_hosted`): the steps that did not
replay launch the picked kernel once each, each capture launches it once
in its warm-up and records it once, and ``tpe.graph.replays`` counts the
replays, which the kernels line adds to its graph replays.

Prints the card's name and power limit first and again before the
kernels line, each phase's wall seconds as it ends and a ``phase
seconds:`` JSON line of all of them, one ``{"kernels": [...]}`` JSON line
before the last, and
as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import contextlib
import copy
import cProfile
import io
import json
import math
import os
import pickle
import pickletools
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial
from types import SimpleNamespace
from xml.etree import ElementTree

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import graft_entry_torch as graft  # noqa: E402
import hyperopt_tpu_torch as ho  # noqa: E402
from hyperopt_tpu_torch import (  # noqa: E402
    base, device, fleet, history, hp, tpe)
from hyperopt_tpu_torch.obs import costs, devtel, metrics  # noqa: E402
from hyperopt_tpu_torch.obs import trace as obs_trace  # noqa: E402
from hyperopt_tpu_torch.obs.events import EVENTS  # noqa: E402
from hyperopt_tpu_torch.ops import ei_scores as ei_mod  # noqa: E402
from hyperopt_tpu_torch.ops import lane_uniforms  # noqa: E402
from hyperopt_tpu_torch.ops import set_weights as sw_op  # noqa: E402
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
# obs: trials per run from empty (a, b), the fleet's lanes (b), and the
# lanes whose slabs are held against their solo runs.
OBS_RUN = 1000
OBS_LANES = 8
OBS_SOLO_LANES = (0, OBS_LANES - 1)
# pipeline: trials each run adds after the 1,000-trial history, the sleep
# the objective adds (a cheap user objective of the order of the hosted
# step), the pool's width and the cut of run (g).
PIPE_RUN = 64
PIPE_SLEEP_S = 0.010
PIPE_POOL = 4
PIPE_TIMEOUT_S = 2.0
# tpe_rest: trials after the history at stride 1 (b), per run from empty
# (b, d), lanes and trials per lane of the joint and Gumbel fleet runs
# (c, d), experiments of the joint cohort (c), trials of the qmc-started
# run (e), of the pipelined suggest_quantile run (f), and the history and
# steps of the run that crosses the 1,024 bucket (f).
REST_MORE = 16
REST_RUN = 256
REST_LANES = 4
REST_FLEET_RUN = 64
REST_QMC = 25
REST_PIPE = 64
REST_BUCKET = 1024
REST_BUCKET_HISTORY = 1020
REST_BUCKET_STEPS = 10
# heads: the unique heads of the backend registry (each run for
# HEADS_MORE hosted trials after the history), the TPE family among them,
# ATPE's trials in (b), timed GP/ES dispatches per size in (c), and the
# candidate counts at which K1 is held against its plain version (tpe_mv's
# and ATPE's at the flagship width).
HEADS = ["rand", "qmc", "halton", "tpe", "tpe_quantile", "tpe_sobol",
         "tpe_mv", "anneal", "atpe", "gp", "es"]
TPE_FAMILY = {"tpe", "tpe_quantile", "tpe_sobol", "tpe_mv"}
HEADS_MORE = 16
HEADS_ATPE = 64
HEADS_TIMED = 10
HEADS_K1_CANDIDATES = (128, 256, 512)
# dispatch: trials after the history of each hosted run (b), timed
# dispatches per turn (b), trials of the one-run device-mode runs (d), runs
# and trials of the restarts and fleet runs (d, e), lanes of the fleet
# (e), starts of the multi-start call (f), trials after startup and worker
# processes of the driver run (g), trials of the backfilled run (h).
DISPATCH_MORE = 16
DISPATCH_TIMED = 10
DISPATCH_RUN = 1000
DISPATCH_RUNS = 8
DISPATCH_RUNS_TRIALS = 256
DISPATCH_LANES = 8
DISPATCH_STARTS = 8
DISPATCH_DRIVER = 64
DISPATCH_WORKERS = 2
DISPATCH_OBS_RUN = 256
# contract: replays of the captured entry() step.
CONTRACT_REPLAYS = 10
# netstore: server-side proposals at seeds 0..15 (b), the seed of each
# head's one proposal (c), timed calls per turn (d), trials of the driven
# run after startup and its worker processes (e), the server's token.
NET_SUGGESTS = 16
NET_HEAD_SEED = 21
NET_TIMED = 10
NET_DRIVER = 64
NET_WORKERS = 2
NET_TOKEN = "chip-smoke-token"
# The heads the netstore phase registers to serve K2 and K3 by name.
NET_EXTRA_HEADS = {"tpe_bf16": dict(ei_precision="bf16"),
                   "tpe_mxu": dict(ei_impl="mxu")}
# service: tenants of the service phase, the cohort window (ms), windows
# in a row, and the seeds of its server-side proposals.
SVC_TENANTS = 8
SVC_WINDOW_MS = 200.0
SVC_WINDOWS = 3
SVC_SEED = 300
# examples: the directory of the port's example scripts, the rule their
# result lines follow (``tests/test_torch_examples.py``: ``best``, ``loss``
# or ``error`` and a finite number), and the TPE steps of 04's sharded
# run (60 trials, the first 20 random startup draws).
EXAMPLES_DIR = "examples_torch"
EXAMPLE_RESULT = re.compile(r"\b(?:best|loss|error)\b\s*:?\s*"
                            r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?)")
EXAMPLE_SHARDED = 40
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


def phase_lane_uniforms(dev):
    """The one-launch draw of every lane's uniforms at the fleet's shape
    (the flagship space at ``N_CAND`` candidates; 1 and 64 lanes, each a
    startup and a TPE generator stream): its sheets against the
    ``torch.rand`` calls it replaces (``cs.draw_uniforms`` and
    ``draw_noise`` on each lane's two generators, then the lanes'
    stacks) and against its plain twin, bit for bit; CUDA-event ms beside
    its bound (the bytes it writes at ``HBM_BYTES_PER_S``), the twin's
    ms, and those calls' ms (``library_ms``), eager and replayed from a
    CUDA graph with the generators registered, reseeded before each
    replay (the parent's in-graph draws).  Prints one ``lane_uniforms
    json:`` line per lane count."""
    cs = compile_space(flagship_space())
    kern = tpe.get_kernel(cs, 1024, N_CAND, 25, device=dev)
    rng = np.random.default_rng(25)
    for lanes in (1, 64):
        seg = SimpleNamespace(cs=cs, kern=kern, n_lanes=lanes,
                              device=dev)
        device._Segment._plan_draws(seg, *lane_uniforms.card_shape(dev))
        seeds = [int(s) for s in rng.integers(0, 2 ** 31 - 1, lanes)]
        seg.seeds.copy_(torch.tensor(seeds, dtype=torch.int64))
        gens = [torch.Generator(device=dev) for _ in range(2 * lanes)]

        def reseed():
            for j, s in enumerate(seeds):
                gens[2 * j].manual_seed(s)
                gens[2 * j + 1].manual_seed(s)

        def library():
            starts = [cs.draw_uniforms(1, gens[2 * j], dev)
                      for j in range(lanes)]
            nz = tpe.stack_noise([kern.draw_noise(gens[2 * j + 1])
                                  for j in range(lanes)])
            return {k: torch.cat([u[k] for u in starts])
                    for k in starts[0]}, nz

        def sheets(su, nz):
            return list(su.values()) + [t for pair in nz["cont"]
                                        for t in pair] + [nz["cat"]]

        lane_uniforms.draw(seg.plan, seg.seeds)
        reseed()
        want = sheets(*library())
        got = sheets(seg.su, seg.nz)
        for g, w in zip(got, want):
            if not torch.equal(g.reshape(-1).view(torch.int32),
                               w.reshape(-1).view(torch.int32)):
                fail(f"lane_uniforms: {lanes} lanes: a sheet of shape "
                     f"{tuple(g.shape)} differs from torch.rand's")
        for slot, offset, numel, grid, out in seg.plan.sheets:
            twin = lane_uniforms.uniform_sheet_reference(
                seeds[slot], offset, numel, grid, device=dev)
            if not torch.equal(out.reshape(-1).view(torch.int32),
                               twin.view(torch.int32)):
                fail(f"lane_uniforms: {lanes} lanes: the twin differs on "
                     f"lane {slot}'s sheet of {numel}")
        floats = sum(numel for _, _, numel, _, _ in seg.plan.sheets)
        blocks = seg.plan.philox_blocks
        bound_ms = 4 * floats / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: lane_uniforms.draw(seg.plan, seg.seeds))
        plain_ms = cuda_ms(lambda: [
            lane_uniforms.uniform_sheet_reference(
                seeds[slot], offset, numel, grid, device=dev)
            for slot, offset, numel, grid, _ in seg.plan.sheets],
            reps=3, warmup=1, inner=1)

        def eager():
            reseed()
            library()

        library_ms = cuda_ms(eager, reps=5, warmup=1, inner=2)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            reseed()
            library()
        torch.cuda.current_stream(dev).wait_stream(side)
        for g in gens:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            library()

        def replayed():
            reseed()
            graph.replay()

        replay_ms = cuda_ms(replayed, reps=5, warmup=1, inner=4)
        reseed()
        graph.replay()
        torch.cuda.synchronize()
        print(f"lane_uniforms: {lanes} lanes, {len(seg.plan.sheets)} "
              f"sheets, {floats} floats, {blocks} Philox blocks: kernel "
              f"{ms:.4f} ms (bound {bound_ms:.4f}, bytes), twin "
              f"{plain_ms:.3f}, torch.rand calls {library_ms:.4f} eager, "
              f"{replay_ms:.4f} replayed with {2 * lanes} generators; "
              f"bitwise equal to torch.rand and to the twin")
        print("lane_uniforms json: " + json.dumps({
            "lanes": lanes, "sheets": len(seg.plan.sheets),
            "floats": floats, "philox_blocks": blocks,
            "blocks": seg.plan.n_blocks, "ms": ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "plain_ms": plain_ms,
            "library_ms": library_ms, "library_graph_ms": replay_ms,
            "bitwise": True}))


def phase_set_weights(dev):
    """Both split sets' weights of the flagship's density group (31
    columns, bucket 1,024, 1,000 rows filled) at 1 and 64 lanes: the
    kernel against its twin (``set_weights_reference``, the
    ``torch.cumsum`` composition it replaces) bit for bit; CUDA-event ms
    eager and replayed from a CUDA graph (``graph_ms``, as the captured
    step runs it) beside its bound (the bytes it moves at
    ``HBM_BYTES_PER_S``: act read once, both sets' masks and weights
    written) and the twin's ms, eager (``plain_ms``) and replayed from a
    CUDA graph (``library_ms``, as the captured step ran it).  Prints one ``set_weights json:`` line per
    lane count, and the kernel's registers from the build report."""
    rows, cols, filled, lf = 1024, 31, 1000, 25
    log = ei_mod.build_log.get("set_weights", "")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    gen = torch.Generator(device=dev).manual_seed(27)
    for lanes in (1, 64):
        live = torch.arange(rows, device=dev) < filled
        u = torch.rand((lanes, rows), generator=gen, device=dev)
        below = live & (u < 0.025)
        above = live & ~below
        act = live[:, None] & (torch.rand((lanes, rows, cols), generator=gen,
                                          device=dev) < 0.9)

        def kernel():
            return sw_op.set_weights(below, above, act, lf)

        def twin():
            return [sw_op.set_weights_reference(s, act, lf)
                    for s in (below, above)]

        for got, want in zip(kernel(), twin()):
            for g, w in zip(got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                if not torch.equal(g, w):
                    fail(f"set_weights: {lanes} lanes: the kernel differs "
                         f"from the twin")
        cells = lanes * rows * cols
        moved = cells * (1 + 2 * (1 + 4)) + 2 * lanes * rows + 2 * 8 * (
            lanes * cols)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(twin)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            twin()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            twin()
        library_ms = cuda_ms(graph.replay)
        # The kernel as the captured step runs it: LAUNCHES_PER_WINDOW
        # launches in one graph, so no host time per launch is in it.
        kernel_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(kernel_graph):
            for _ in range(LAUNCHES_PER_WINDOW):
                kernel()
        graph_ms = cuda_ms(kernel_graph.replay, inner=1) / LAUNCHES_PER_WINDOW
        torch.cuda.synchronize()
        print(f"set_weights: {lanes} x {rows} x {cols}, {moved} bytes: "
              f"kernel {ms:.4f} ms eager, {graph_ms:.4f} in a graph (bound "
              f"{bound_ms:.4f}, bytes), twin {plain_ms:.4f} eager, "
              f"{library_ms:.4f} replayed; registers {regs}; bitwise equal "
              f"to the twin")
        print("set_weights json: " + json.dumps({
            "lanes": lanes, "rows": rows, "cols": cols, "bytes": moved,
            "ms": ms, "graph_ms": graph_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "plain_ms": plain_ms,
            "library_ms": library_ms, "registers": regs, "bitwise": True}))


def phase_suggest_step(dev):
    space = flagship_space()
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = synthetic_trials(domain.cs, N_HISTORY, 0, dev)
    algo = partial(tpe.suggest_batch, n_EI_candidates=N_CAND)
    tid = trials.new_trial_ids(1)
    times = []
    eager = 0
    for step in range(6):
        ei_mod.reset_launches()
        g0 = graph_counts()
        t0 = time.perf_counter()
        vals, _ = algo(tid, domain, trials, seed=step)
        times.append((time.perf_counter() - t0) * 1e3)
        eager += check_hosted(f"suggest_step: step {step}", "f32", 1,
                              graph_moved(g0))
        bad = in_bounds(domain.cs, vals[0])
        if bad:
            fail(f"suggest_step: proposal outside the space: {bad}")
    steady_ms = float(np.median(times[1:]))
    print(f"suggest_step: P={domain.cs.n_params} history={N_HISTORY} "
          f"n_cand={N_CAND} first_ms={times[0]:.2f} "
          f"steady_ms_median={steady_ms:.2f}; K1 once per step, {eager} "
          f"of 6 eager, the others replays of the hosted step graph")
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
    kernel the profiler saw, replayed graphs' kernels included.  The
    session opens with ``obs_trace.profiler_lead_in``, whose empty kernels
    are left out: without it the profiler now and then lost the records
    of a session's first moments."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        obs_trace.profiler_lead_in(torch.cuda.current_device())
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.count,
                (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)) / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and obs_trace.LEAD_IN_KERNEL not in e.key]
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
    tally = Tally()
    t0 = time.perf_counter()
    tally.counted("f32", lambda: ho.fmin(
        objective, space, algo=partial(tpe.suggest, n_EI_candidates=N_CAND),
        max_evals=N_HISTORY + N_MORE, trials=trials,
        rstate=np.random.default_rng(0), device=dev,
        show_progressbar=False))
    wall = time.perf_counter() - t0
    eager = check_hosted("fmin", "f32", N_MORE, tally.graphs)
    if len(trials) != N_HISTORY + N_MORE:
        fail(f"fmin: {len(trials)} trials, wanted {N_HISTORY + N_MORE}")
    for t in trials:
        if t["state"] != base.JOB_STATE_DONE or \
                not math.isfinite(t["result"]["loss"]):
            fail(f"fmin: trial {t['tid']} is not DONE with a finite loss")
    print(f"fmin: {N_MORE} trials in {wall:.3f} s = {N_MORE / wall:.2f} "
          f"trials/s, best loss {trials.best_trial['result']['loss']:.4g}, "
          f"K1 once per TPE step: {eager} eager, {tally.graphs['replays']} "
          f"replays of the hosted step graph ({tally.graphs['captures']} "
          f"captures)")
    return tally.rows()


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


GRAPH_COUNTERS = ("captures", "replays", "eager_steps")


def graph_counts():
    """The hosted step graphs' counters now (``tpe.graph.*``)."""
    snap = metrics.registry().snapshot()["counters"]
    return {k: int(snap.get(f"tpe.graph.{k}", 0)) for k in GRAPH_COUNTERS}


def graph_moved(before):
    """How far the hosted step graphs' counters moved since ``before``."""
    now = graph_counts()
    return {k: now[k] - before[k] for k in GRAPH_COUNTERS}


def check_hosted(what, low, steps, graphs, got=None):
    """``steps`` TPE steps ran the kernel of lowering ``low`` (None: a
    space with no density column, which runs none) once each: eagerly (a
    kernel's first hosted step, a batch, a head that calls the kernel
    itself) or in a replay of a hosted step graph (``graphs``: the graph
    counters' moves over the same block).  Each capture launches the
    kernel once in its warm-up and records it once into the graph, so the
    wrapper counts ``steps - replays + captures`` eager launches and
    ``captures`` recordings of ``low``, none of the other lowerings; no
    capture failed, and each capture was a replayed step.  ``got``: the
    wrapper's ``(launches_by, recorded_by)`` read after the block (by
    default, now).  Returns the eager steps."""
    eager = steps - graphs["replays"]
    want = ({k: (eager + graphs["captures"]) * (k == low) for k in KERNELS},
            {k: graphs["captures"] * (k == low) for k in KERNELS})
    if got is None:
        got = (dict(ei_mod.ei_scores.launches_by),
               dict(ei_mod.ei_scores.recorded_by))
    if got != want or eager < 0 or graphs["eager_steps"] \
            or graphs["captures"] > graphs["replays"]:
        fail(f"{what}: wrapper launches and records {got}, hosted graphs "
             f"{graphs}; wanted {want} for {steps} TPE steps")
    return eager


class Tally:
    """A phase's EI kernel counts per lowering, summed over its runs: eager
    launches, launches recorded into graphs, and replays of graphs that
    hold the kernel (one kernel run per replay, whatever the lanes):
    device mode's and the hosted step's (every space the phases run has a
    density column, so a hosted graph holds K1; :func:`check_hosted`
    checks that each capture records it)."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.recorded = dict.fromkeys(KERNELS, 0)
        self.replayed = dict.fromkeys(KERNELS, 0)
        self.graphs = dict.fromkeys(GRAPH_COUNTERS, 0)

    def counted(self, low, run):
        """``run()`` with the device counters and the wrapper's counts set
        to 0 just before it; adds what it launched, recorded into graphs
        and replayed (graphs of lowering ``low``) to the tallies, and
        keeps the hosted graph counters' moves in ``graphs``."""
        device.reset_counters()
        ei_mod.reset_launches()
        g0 = graph_counts()
        try:
            return run()
        finally:
            self.graphs = graph_moved(g0)
            for k in KERNELS:
                self.launches[k] += ei_mod.ei_scores.launches_by[k]
                self.recorded[k] += ei_mod.ei_scores.recorded_by[k]
            self.replayed[low] += device.replays + self.graphs["replays"]

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
    launch queue): the trial's lane seeds into the segment's seed buffer
    (one non-blocking copy from a pinned table, as ``_Segment.run``
    makes it), then ``graph.replay()``; ms, averaged over
    ``DEVICE_PROFILED`` replays."""
    load(seg, h, rows)
    table = torch.from_numpy(replay_seeds(seg)).pin_memory()
    seed_s = replay_s = 0.0
    for t in range(DEVICE_PROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg.seeds.copy_(table[t], non_blocking=True)
        t1 = time.perf_counter()
        seg.graph.replay()
        t2 = time.perf_counter()
        seed_s += t1 - t0
        replay_s += t2 - t1
    torch.cuda.synchronize()
    return (seed_s * 1e3 / DEVICE_PROFILED, replay_s * 1e3 / DEVICE_PROFILED)


def segment_of(cs, fn, n_cap, lanes=1, telemetry=True):
    """The cached device-mode segment of objective ``fn`` at bucket
    ``n_cap`` with ``lanes`` lanes, armed or not (built by an
    ``fmin(mode="device")``, ``fmin_device`` or ``fmin_fleet`` run)."""
    return next(seg for f, seg in cs._device_runs.values()
                if f is fn and seg.n_cap == n_cap and seg.n_lanes == lanes
                and seg.telemetry == telemetry)


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
              f"host: its seeds copied {seed_ms:.3f} ms, graph.replay() "
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
                    n_lanes=lanes, telemetry=devtel.enabled()))
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


class slabs_seen:
    """Within the block, record each ``(mode, slab)`` that device mode hands
    ``devtel.backfill_segment``."""

    def __enter__(self):
        self.seen = []
        self._orig = orig = devtel.backfill_segment

        def spy(reg, **kw):
            self.seen.append((kw["mode"], kw["slab_h"]))
            return orig(reg, **kw)

        devtel.backfill_segment = spy
        return self.seen

    def __exit__(self, *exc):
        devtel.backfill_segment = self._orig
        return False


def slabs_equal(a, b, j):
    """Whether lane ``j`` of slab ``a`` equals the one-lane slab ``b``, bit
    for bit."""
    return all(np.array_equal(a[k][j], b[k][0]) for k in a)


def obs_device_runs(dev, space, cs, algo, obj, counted):
    """(a): solo device mode armed and disarmed at strides None and 8.
    Returns the armed stride-None run's ``(trials, slabs)``."""
    n = OBS_RUN
    n_startup = tpe._default_n_startup_jobs
    runs = {}
    for stride in (None, 8):
        for armed in (True, False):
            devtel.set_enabled(armed)
            with slabs_seen() as seen:
                t0 = time.perf_counter()
                t = counted("f32", lambda: device_fmin(
                    obj, space, algo, ho.Trials(), n, stride, dev, 12))
                wall = time.perf_counter() - t0
            fetches = -(-n // (stride or n))
            arm = "armed" if armed else "disarmed"
            check_counters(f"obs (a) stride {stride} {arm}",
                           captures=int(stride is None), replays=n,
                           eager_steps=0, fetch_syncs=fetches,
                           segments=fetches)
            check_captures(f"obs (a) stride {stride} {arm}", "f32")
            slabs = [sl for mode, sl in seen if mode == "solo"]
            if len(slabs) != (fetches if armed else 0):
                fail(f"obs (a) stride {stride} {arm}: {len(slabs)} slabs "
                     f"for {fetches} segments")
            runs[(stride, armed)] = (t, slabs)
            print(f"obs (a): stride {stride} {arm}: {n} trials in "
                  f"{wall:.3f} s = {n / wall:.1f} trials/s"
                  + (" (capture included)" if stride is None else "")
                  + f", {fetches} fetches")
        (ta, slabs), (td, _) = runs[(stride, True)], runs[(stride, False)]
        diffs = column_diffs(landed(ta, 0), landed(td, 0))
        if diffs or len(ta) != n or len(td) != n:
            fail(f"obs (a) stride {stride}: armed and disarmed runs land "
                 f"different trials: {diffs}")
        losses = np.asarray([d["result"]["loss"] for d in ta], np.float32)
        n_tpe = sum(int(sl["tpe_steps"][0]) for sl in slabs)
        best = slabs[-1]["best_loss"][0]
        if n_tpe != n - n_startup or best != losses.min():
            fail(f"obs (a) stride {stride}: slab tpe_steps {n_tpe} (wanted "
                 f"{n - n_startup}), best {best} (the trials' {losses.min()})")
        ei_sum = sum(float(sl["ei_sum"][0]) for sl in slabs)
        print(f"obs (a): stride {stride}: armed and disarmed land identical "
              f"trials (misc.vals and losses) with equal fetches; slab: "
              f"tpe_steps={n_tpe} best_loss={best:.6g} (the trials' best) "
              f"ei_max={max(float(sl['ei_max'][0]) for sl in slabs):.6g} "
              f"ei_mean={ei_sum / n_tpe:.6g} argmax_ties="
              f"{sum(int(sl['argmax_ties'][0]) for sl in slabs)} "
              f"nonfinite={sum(int(sl['nonfinite'][0]) for sl in slabs)}")
    devtel.set_enabled(True)
    # The card's time and kernels per replay of each arm's graph, after
    # 1,000 rows, in turns.
    ta = runs[(None, True)][0]
    h = ta.history(cs)
    segs = {arm: segment_of(cs, obj, tpe._bucket(n), telemetry=arm)
            for arm in (True, False)}
    card = {True: [], False: []}
    for arm in (False, True, True, False):
        enqueue_ms, card_ms = counted("f32",
                                      lambda: replay_ms(segs[arm], h, n))
        check_counters("obs (a) timed segment", replays=DEVICE_PROFILED,
                       captures=0)
        card[arm].append((card_ms, enqueue_ms))
    per_replay = {}
    for arm in (False, True):
        load(segs[arm], h, n)
        wall_ms, kernels = counted("f32", lambda: profiled(
            lambda: segs[arm].run(replay_seeds(segs[arm]))))
        seen = kernel_counts(kernels)
        if seen != {k: DEVICE_PROFILED * (k == "f32") for k in seen}:
            fail(f"obs (a): the profiler counted {seen} EI kernel runs in "
                 f"{DEVICE_PROFILED} replays")
        per_replay[arm] = sum(c for _, c, _ in kernels) / DEVICE_PROFILED
        busy = sum(m for _, _, m in kernels) / DEVICE_PROFILED
        print(f"obs (a): {'armed' if arm else 'disarmed'} graph: card ms per "
              f"replay {', '.join(f'{c:.4f}' for c, _ in card[arm])} (CUDA "
              f"events, turns disarmed, armed, armed, disarmed), host "
              f"enqueue ms per replay "
              f"{', '.join(f'{e:.4f}' for _, e in card[arm])}; profiled: "
              f"cuda_kernels_per_replay={per_replay[arm]:.2f} "
              f"device_busy_ms_per_replay={busy:.4f}; pool "
              f"{segs[arm].pool_bytes} bytes")
    extra = per_replay[True] - per_replay[False]
    if not 0 <= extra <= 4:
        fail(f"obs (a): the armed graph runs {extra:.2f} more kernels per "
             f"replay than the disarmed one (at most 4)")
    print(f"obs (a): the slab adds {extra:.2f} kernels per replay")
    return runs[(None, True)]


def phase_obs(dev, show=None):
    """The observability layer at full width, checks (a) to (d).  Returns
    ``{lowering: (eager launches, launches recorded into graphs, replays
    of graphs that hold the kernel)}`` over its runs.  With ``show`` (a
    :class:`ShowSteps`), (c)'s trace directory and trials go through its
    step (a) and the directory is kept for its merge."""
    space = flagship_space()
    cs = compile_space(space)
    algo = partial(tpe.suggest, n_EI_candidates=N_CAND)
    t_phase = time.perf_counter()
    tally = Tally()
    counted = tally.counted
    obj = make_objective_torch()
    solo_t, solo_slabs = obs_device_runs(dev, space, cs, algo, obj, counted)

    # (b) the fleet at 8 lanes, armed: lanes 0 and 7 against their solo
    # runs (seed 12 + j; lane 0's is (a)'s armed stride-None run).
    n = OBS_RUN
    with slabs_seen() as seen:
        infos = counted("f32", lambda: fleet.fmin_fleet(
            obj, cs, OBS_LANES, n, seed=12, device=dev,
            n_EI_candidates=N_CAND))
    check_counters("obs (b) fleet", captures=1, replays=n, eager_steps=0,
                   fetch_syncs=1)
    fleet_slabs = [sl for mode, sl in seen if mode == "fleet"]
    for j in OBS_SOLO_LANES:
        if j == 0:
            t, slabs = solo_t, solo_slabs
        else:
            with slabs_seen() as seen:
                t = counted("f32", lambda: device_fmin(
                    obj, space, algo, ho.Trials(), n, None, dev, 12 + j))
            slabs = [sl for mode, sl in seen if mode == "solo"]
        losses = np.asarray([d["result"]["loss"] for d in t], np.float32)
        if len(slabs) != len(fleet_slabs) or not all(
                slabs_equal(f, o, j) for f, o in zip(fleet_slabs, slabs)) \
                or not np.array_equal(infos[j]["losses"], losses):
            fail(f"obs (b): lane {j} of {OBS_LANES}: its slab or trials "
                 f"differ from its solo run's")
        tel = infos[j]["telemetry"]
        print(f"obs (b): fmin_fleet lane {j} of {OBS_LANES}: slab equals "
              f"the solo run's bit for bit (tpe_steps={tel['tpe_steps']} "
              f"best_loss={tel['best_loss']:.6g} "
              f"ei_max={tel['ei_max']:.6g})")

    # (c) a hosted fmin(trace_dir=): the torch.profiler export names the
    # EI kernel once per TPE step.
    trials = synthetic_trials(cs, N_HISTORY, 1, dev)
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        counted("f32", lambda: ho.fmin(
            objective, space, algo=algo, max_evals=N_HISTORY + N_MORE,
            trials=trials, rstate=np.random.default_rng(0), device=dev,
            show_progressbar=False, trace_dir=trace_dir))
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(trace_dir))
        want = ["chrome_trace.json", "loop_events.jsonl", "loop_trace.json",
                obs_trace.PROFILER_TRACE]
        if files != sorted(want):
            fail(f"obs (c): trace dir holds {files}, wanted {want}")
        with open(os.path.join(trace_dir, obs_trace.PROFILER_TRACE)) as fh:
            prof = json.load(fh)["traceEvents"]
        gpu = [e for e in prof if e.get("cat") == "kernel"]
        runs = {low: sum(sym in e.get("name", "") for e in gpu)
                for low, sym in KERNEL_SYMBOLS.items()}
        graphs = tally.graphs
        check_hosted("obs (c)", "f32", N_MORE, graphs)
        # The card ran K1 once per step, eager or replayed, and once more
        # in each capture's warm-up.
        if runs != {k: (N_MORE + graphs["captures"]) * (k == "f32")
                    for k in runs}:
            fail(f"obs (c): the profiler export names the EI kernels "
                 f"{runs} times for {N_MORE} TPE steps and "
                 f"{graphs['captures']} captures")
        types = {}
        with open(os.path.join(trace_dir, "loop_events.jsonl")) as fh:
            for line in fh:
                etype = json.loads(line)["type"]
                types[etype] = types.get(etype, 0) + 1
        with open(os.path.join(trace_dir, "loop_trace.json")) as fh:
            spans = json.load(fh)
        size = os.path.getsize(os.path.join(trace_dir,
                                            obs_trace.PROFILER_TRACE))
        if show is not None:
            show.trace(trace_dir, trials)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"obs (c): fmin(trace_dir=) from {N_HISTORY} trials, {N_MORE} "
          f"TPE steps in {wall:.3f} s (profiler start and export "
          f"included): the export ({size} bytes, {len(gpu)} kernel events) "
          f"names {KERNEL_SYMBOLS['f32']} {runs['f32']} times, once per "
          f"step ({graphs['replays']} of them replays of the hosted step "
          f"graph, {graphs['captures']} captures); events "
          f"{dict(sorted(types.items()))}; spans "
          + ", ".join(f"{k} {v['count']}x {v['mean_ms']} ms"
                      for k, v in spans.items() if k != "_wall")
          + f"; coverage {spans['_wall']['coverage']}")

    # (d) the hosted step with the obs layer armed and disarmed, the same
    # 20 steps each time, in turns after a warm-up run (the host's noise
    # between runs is milliseconds); then the hooks' own time in one more
    # armed run, by cProfile.
    history0 = synthetic_trials(cs, N_HISTORY, 3, dev)

    def hosted(armed, prof=None):
        metrics.set_enabled(armed)
        (costs.arm if armed else costs.disarm)()
        (EVENTS.enable if armed else EVENTS.disable)()
        t = base.trials_from_docs(copy.deepcopy(list(history0)))
        try:
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            counted("f32", lambda: ho.fmin(
                objective, space, algo=algo, max_evals=N_HISTORY + N_MORE,
                trials=t, rstate=np.random.default_rng(5), device=dev,
                show_progressbar=False))
            if prof is not None:
                prof.disable()
            ms = (time.perf_counter() - t0) * 1e3 / N_MORE
        finally:
            metrics.set_enabled(True)
            costs.disarm()
            costs.clear()
            EVENTS.disable()
            EVENTS.clear()
        return ms, landed(t, N_HISTORY)

    _, first = hosted(False)
    step_ms = {True: [], False: []}
    for armed in (False, True, True, False) * 3:
        ms, rows = hosted(armed)
        if column_diffs(rows, first) or len(rows) != N_MORE:
            fail("obs (d): an armed hosted run landed other trials")
        step_ms[armed].append(ms)
    prof = cProfile.Profile()
    hosted(True, prof)
    hook_s = sum(
        st[2] for (path, _, name), st in pstats.Stats(prof).stats.items()
        if os.sep + "obs" + os.sep in path or path.endswith("faults.py")
        or name in ("_bump", "_obs_ms"))
    print(f"obs (d): hosted step, host ms per step over the same {N_MORE} "
          f"steps (turns disarmed, armed, armed, disarmed, three times): "
          f"disarmed {', '.join(f'{m:.3f}' for m in step_ms[False])}"
          f", armed {', '.join(f'{m:.3f}' for m in step_ms[True])}; armed "
          f"minus disarmed, means "
          f"{np.mean(step_ms[True]) - np.mean(step_ms[False]):.3f} ms, "
          f"medians {np.median(step_ms[True]) - np.median(step_ms[False]):.3f}"
          f" ms; the hooks' own time in an armed run by cProfile (its own "
          f"cost per call included: an upper bound) "
          f"{hook_s * 1e3 / N_MORE:.4f} ms per step")
    print(f"obs: EI wrapper over the phase: eager launches {tally.launches}, "
          f"recorded into graphs {tally.recorded}, graph replays "
          f"{tally.replayed}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


def sleepy_objective(cfg):
    """:func:`objective` plus a fixed sleep (it releases the interpreter
    lock, as waiting on I/O or on the card does)."""
    time.sleep(PIPE_SLEEP_S)
    return objective(cfg)


def forked_objective(cfg):
    """:func:`sleepy_objective` reporting where it ran: its pid, and
    whether it is a fork of a process with a live CUDA context (a flag
    read; any CUDA call would raise there)."""
    return {"loss": sleepy_objective(cfg), "status": base.STATUS_OK,
            "attachments": {"pid": os.getpid(),
                            "bad_fork": bool(torch.cuda._is_in_bad_fork())}}


class CountedTpe:
    """``tpe.suggest``'s four halves at ``n_EI_candidates=N_CAND`` with its
    TPE dispatches counted: each pending handle records how many
    proposals it asked for."""

    def __init__(self):
        self.sizes = []

    def algo(self):
        def dispatch(new_ids, domain, trials, seed):
            handle = tpe.suggest_dispatch(new_ids, domain, trials, seed,
                                          n_EI_candidates=N_CAND)
            if handle[0] == "pending":
                self.sizes.append(len(new_ids))
            return handle

        def suggest(new_ids, domain, trials, seed):
            return tpe.suggest_materialize(
                dispatch(new_ids, domain, trials, seed))

        suggest.dispatch = dispatch
        suggest.materialize = tpe.suggest_materialize
        suggest.start_transfer = tpe.suggest_start_transfer
        suggest.handle_ready = tpe.suggest_handle_ready
        return suggest

    def steps(self):
        """TPE steps the dispatches ran: one per proposal, a batch of
        ``n`` running the next power of two."""
        return sum(tpe._batch_size_for(n) for n in self.sizes)


class observed:
    """The raw values every registry histogram observed inside the block,
    by name (the registry keeps bucket bounds only)."""

    def __enter__(self):
        self.values = {}
        self._orig = orig = metrics.Histogram.observe
        values = self.values

        def observe(h, v):
            values.setdefault(h.name, []).append(v)
            orig(h, v)

        metrics.Histogram.observe = observe
        return self

    def __exit__(self, *exc):
        metrics.Histogram.observe = self._orig


def pct(values, q):
    return float(np.percentile(values, q)) if values else float("nan")


def reference_overlap(history0, space, dev, seed):
    """The depth-1 overlap loop, inline, on the card (the port's copy of
    ``tests/test_pipeline.py::_reference_overlap_stream``): materialize the
    pending proposal, insert it, dispatch the next on the just-inserted NEW
    trial, then evaluate; one ``rstate`` draw per dispatch, before the
    ids."""
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = base.trials_from_docs(copy.deepcopy(history0))
    rstate = np.random.default_rng(seed)
    max_evals = N_HISTORY + PIPE_RUN
    pending = None

    def n_done():
        return sum(d["state"] in (base.JOB_STATE_DONE, base.JOB_STATE_ERROR)
                   for d in trials._dynamic_trials)

    while n_done() < max_evals:
        remaining = max_evals - len(trials._dynamic_trials)
        n_to_enqueue = min(1, remaining)
        if pending is not None:
            docs = tpe.suggest.materialize(pending)[:n_to_enqueue]
            pending = None
        else:
            s = int(rstate.integers(2 ** 31 - 1))
            ids = trials.new_trial_ids(n_to_enqueue)
            trials.refresh()
            docs = tpe.suggest(ids, domain, trials, s,
                               n_EI_candidates=N_CAND)
        if not docs:
            break
        trials.insert_trial_docs(docs)
        trials.refresh()
        if remaining > n_to_enqueue:
            s = int(rstate.integers(2 ** 31 - 1))
            ids = trials.new_trial_ids(min(1, remaining - n_to_enqueue))
            pending = tpe.suggest.dispatch(ids, domain, trials, s,
                                           n_EI_candidates=N_CAND)
        for doc in trials._dynamic_trials:
            if doc["state"] == base.JOB_STATE_NEW:
                doc["result"] = domain.evaluate(
                    base.spec_from_misc(doc["misc"]),
                    base.Ctrl(trials, current_trial=doc))
                doc["state"] = base.JOB_STATE_DONE
        trials.refresh()
    return trials


def check_settled(what, trials, finite=True):
    """No trial NEW or RUNNING, no tid twice, finite losses (when
    ``finite``) on every DONE trial."""
    tids = [d["tid"] for d in trials]
    if len(set(tids)) != len(tids):
        fail(f"pipeline {what}: duplicate tids")
    states = {d["state"] for d in trials}
    if states & {base.JOB_STATE_NEW, base.JOB_STATE_RUNNING}:
        fail(f"pipeline {what}: trials left NEW or RUNNING")
    if finite and any(d["state"] != base.JOB_STATE_DONE
                      or not math.isfinite(d["result"]["loss"])
                      for d in trials):
        fail(f"pipeline {what}: a trial is not DONE with a finite loss")


def with_new_rows(space, history0, dev):
    """A domain on ``dev``, a Trials holding ``history0``, and the docs of
    5 more finished trials and 3 running ones (tids after the history), to
    insert after a warm dispatch so that the next one appends rows and
    overlays in-flight ones."""
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = base.trials_from_docs(copy.deepcopy(history0))
    more = copy.deepcopy(list(synthetic_trials(domain.cs, 8, 9, dev)))
    for i, d in enumerate(more):
        d["tid"] = d["misc"]["tid"] = N_HISTORY + i
        for k in d["misc"]["idxs"]:
            if d["misc"]["idxs"][k]:
                d["misc"]["idxs"][k] = [d["tid"]]
        if i >= 5:
            d["state"] = base.JOB_STATE_RUNNING
            d["result"] = {"status": base.STATUS_RUNNING}
    return domain, trials, more


def sync_free_dispatch(space, history0, dev):
    """One full-width TPE dispatch and ``start_transfer`` under
    ``torch.cuda.set_sync_debug_mode("error")``, on a warm kernel and a
    warm ring, with new rows to append and trials in flight: neither the
    upload, the fantasy overlay, the step nor the copy may synchronize."""
    domain, trials, docs = with_new_rows(space, history0, dev)
    cs = domain.cs
    tpe.suggest_materialize(tpe.suggest_dispatch(
        trials.new_trial_ids(1), domain, trials, 1, n_EI_candidates=N_CAND))
    trials.insert_trial_docs(docs)
    trials.refresh()
    b0 = history.upload_bytes
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = tpe.suggest_dispatch(trials.new_trial_ids(1), domain, trials,
                                      2, n_EI_candidates=N_CAND)
        tpe.suggest_start_transfer(handle)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    pending = handle[3]
    if handle[0] != "pending" or pending.event is None or \
            not pending.host.is_pinned():
        fail("pipeline: the dispatch's copy did not start into pinned "
             "memory")
    pending.event.synchronize()
    if not tpe.suggest_handle_ready(handle):
        fail("pipeline: a handle whose event passed is not ready")
    row = pending.rows.cpu().numpy()
    got = tpe.suggest_materialize(handle)[0]["misc"]["vals"]
    if not np.array_equal(pending.host.numpy(), row) or in_bounds(cs, row):
        fail("pipeline: the pinned copy differs from the rows on the card")
    p = cs.n_params
    uploaded = history.upload_bytes - b0
    if uploaded != 5 * history._row_bytes(p) + 3 * (4 * p + p):
        fail(f"pipeline: the dispatch uploaded {uploaded} bytes, wanted 5 "
             f"new rows and 3 fantasy rows")
    print(f"pipeline: a warm full-width dispatch (5 new rows appended, 3 "
          f"trials in flight overlaid, {uploaded} bytes uploaded) and its "
          f"start_transfer ran under set_sync_debug_mode('error'); the "
          f"pinned copy equals the card's rows ({len(got)} labels)")


def phase_pipeline(dev):
    """The pipelined loop and the pool at full width, runs (a) to (g).
    Returns ``{lowering: (launches, 0, 0)}`` over its runs."""
    space = flagship_space()
    cs = compile_space(space)
    history0 = list(synthetic_trials(cs, N_HISTORY, 4, dev))
    tally = Tally()
    reg = metrics.registry()
    t_phase = time.perf_counter()
    target = N_HISTORY + PIPE_RUN
    stalls = ("pipeline.stall.suggest_bound", "pipeline.stall.eval_bound")
    guards = ("pipeline.slot.failed", "pipeline.fallbacks")

    def fresh(cls=None, **kw):
        t = ho.Trials() if cls is None else cls(**kw)
        t.insert_trial_docs(copy.deepcopy(history0))
        t.refresh()
        return t

    def run(what, trials, algo, obj=sleepy_objective, **kw):
        c0 = dict(reg.snapshot()["counters"])
        with observed() as seen:
            t0 = time.perf_counter()
            tally.counted("f32", lambda: ho.fmin(
                obj, space, algo=algo, max_evals=target, trials=trials,
                rstate=np.random.default_rng(21), device=dev,
                show_progressbar=False, **kw))
            wall = time.perf_counter() - t0
        c1 = reg.snapshot()["counters"]
        moved = {k: c1.get(k, 0.0) - c0.get(k, 0.0)
                 for k in stalls + guards}
        n_new = len(trials) - N_HISTORY
        return {"what": what, "wall": wall, "rate": n_new / wall,
                "n": n_new, "moved": moved, "seen": seen.values,
                "k1": ei_mod.ei_scores.launches_by["f32"],
                "got": (dict(ei_mod.ei_scores.launches_by),
                        dict(ei_mod.ei_scores.recorded_by)),
                "graphs": tally.graphs}

    results = {}
    hosted = {"a": dict(overlap_depth=0), "b": dict(overlap_suggest=True),
              "c": dict(overlap_depth=2, evaluators=2),
              "d": dict(overlap_depth=4, evaluators=4),
              "e": dict(overlap_depth=2, max_queue_len=8)}
    streams = {}
    for key, kw in hosted.items():
        counter = CountedTpe()
        trials = fresh()
        r = run(key, trials, counter.algo(), **kw)
        check_settled(key, trials)
        if r["n"] != PIPE_RUN:
            fail(f"pipeline ({key}): {r['n']} new trials, wanted {PIPE_RUN}")
        check_hosted(f"pipeline ({key}), {len(counter.sizes)} dispatches",
                     "f32", counter.steps(), r["graphs"], r["got"])
        if any(r["moved"][g] for g in guards):
            fail(f"pipeline ({key}): slot failures or a fallback: "
                 f"{r['moved']}")
        r["dispatches"] = len(counter.sizes)
        results[key] = r
        streams[key] = landed(trials, N_HISTORY)

    # (b) against the inline depth-1 overlap loop, on the card.
    ref = landed(reference_overlap(history0, space, dev, 21), N_HISTORY)
    if streams["b"] != ref:
        fail(f"pipeline (b): overlap_suggest differs from the inline "
             f"overlap loop: {column_diffs(streams['b'], ref)}")
    # Two more depth-2 runs with one evaluator: the same stream.
    twice = []
    for _ in range(2):
        trials = fresh()
        run("det", trials, CountedTpe().algo(), overlap_depth=2,
            evaluators=1)
        check_settled("depth-2 determinism", trials)
        twice.append(landed(trials, N_HISTORY))
    if twice[0] != twice[1]:
        fail(f"pipeline: two depth-2 runs with one evaluator differ: "
             f"{column_diffs(twice[0], twice[1])}")

    # (f) a process pool with TPE on the card: CUDA is live in this
    # process, and no child may touch it.
    parent = os.getpid()
    trials = fresh(ho.PoolTrials, parallelism=PIPE_POOL, execution="process")
    results["f"] = run("f", trials, partial(tpe.suggest,
                                            n_EI_candidates=N_CAND),
                       obj=forked_objective)
    check_settled("f", trials)
    new = list(trials)[N_HISTORY:]
    where = [trials.trial_attachments(d) for d in new]
    if len(new) != PIPE_RUN or any(a["pid"] == parent or not a["bad_fork"]
                                   for a in where):
        fail("pipeline (f): trials not evaluated in forked children of "
             "this CUDA process")
    results["f"]["children"] = len({a["pid"] for a in where})

    # (g) a thread pool cut by fmin(timeout=).
    trials = fresh(ho.PoolTrials, parallelism=PIPE_POOL, execution="thread")
    t0 = time.perf_counter()
    tally.counted("f32", lambda: ho.fmin(
        lambda cfg: (time.sleep(20 * PIPE_SLEEP_S), objective(cfg))[1],
        space, algo=partial(tpe.suggest, n_EI_candidates=N_CAND),
        max_evals=N_HISTORY + 100_000, trials=trials,
        rstate=np.random.default_rng(22), device=dev, timeout=PIPE_TIMEOUT_S,
        show_progressbar=False))
    g_wall = time.perf_counter() - t0
    check_settled("g", trials, finite=False)
    new = list(trials)[N_HISTORY:]
    done = [d for d in new if d["state"] == base.JOB_STATE_DONE]
    cancelled = [d for d in new if d["state"] == base.JOB_STATE_ERROR]
    if not done or any(d["misc"]["error"][0] != "Cancelled"
                       for d in cancelled) or \
            any(not math.isfinite(d["result"]["loss"]) for d in done):
        fail(f"pipeline (g): {len(done)} done, {len(cancelled)} cancelled "
             f"after the timeout")

    sync_free_dispatch(space, history0, dev)

    labels = {"a": "serial", "b": "overlap_suggest",
              "c": "depth 2 x 2 evaluators", "d": "depth 4 x 4 evaluators",
              "e": "depth 2, max_queue_len 8",
              "f": f"PoolTrials({PIPE_POOL}, process)"}
    for key in "abcdef":
        r = results[key]
        occ = r["seen"].get("pipeline.occupancy", [])
        fetch = r["seen"].get("suggest.fetch_sync_ms", [])
        disp = r["seen"].get("suggest.dispatch_ms", [])
        extra = (f", {r['dispatches']} TPE dispatches"
                 if "dispatches" in r else
                 f", {r['children']} child pids")
        print(f"pipeline ({key}) {labels[key]}: {r['n']} trials in "
              f"{r['wall']:.3f} s = {r['rate']:.2f} trials/s; K1 launches "
              f"{r['k1']}, hosted graphs {r['graphs']}{extra}; occupancy p50 {pct(occ, 50):.2f} p95 "
              f"{pct(occ, 95):.2f} ({len(occ)} samples); stalls "
              f"suggest_bound {r['moved'][stalls[0]]:.0f} eval_bound "
              f"{r['moved'][stalls[1]]:.0f}; fetch_sync_ms p50 "
              f"{pct(fetch, 50):.4f} p95 {pct(fetch, 95):.4f} "
              f"({len(fetch)} fetches); host ms per dispatch p50 "
              f"{pct(disp, 50):.3f} p95 {pct(disp, 95):.3f}")
    print(f"pipeline (g) PoolTrials({PIPE_POOL}, thread), fmin(timeout="
          f"{PIPE_TIMEOUT_S}): returned after {g_wall:.3f} s with "
          f"{len(done)} done and {len(cancelled)} cancelled, none left "
          f"NEW or RUNNING")
    fa = results["a"]["seen"].get("suggest.fetch_sync_ms", [])
    fc = results["c"]["seen"].get("suggest.fetch_sync_ms", [])
    print(f"pipeline: suggest.fetch_sync_ms p50/p95, serial (a) "
          f"{pct(fa, 50):.4f}/{pct(fa, 95):.4f} against depth 2 x 2 (c) "
          f"{pct(fc, 50):.4f}/{pct(fc, 95):.4f}; (c)/(a) trials/s "
          f"{results['c']['rate'] / results['a']['rate']:.3f}, (b)/(a) "
          f"{results['b']['rate'] / results['a']['rate']:.3f}; (b) equals "
          f"the inline overlap loop, two depth-2 one-evaluator runs are "
          f"identical; the phase took {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


def phase_tpe_rest(dev, hosted):
    """The rest of TPE at full width, checks (a) to (f).  ``hosted``: the
    factorized step's numbers (suggest_step phase).  Returns ``{lowering:
    (eager launches, launches recorded into graphs, replays of graphs
    that hold the kernel)}`` over its counted runs."""
    space = flagship_space()
    cs = compile_space(space)
    tally = Tally()
    counted = tally.counted
    t_phase = time.perf_counter()
    mv = dict(n_EI_candidates=N_CAND, multivariate=True)
    algo_mv = partial(tpe.suggest, **mv)
    algo_fac = partial(tpe.suggest, n_EI_candidates=N_CAND)

    def only(what, low, n):
        """The last counted run ran ``low``'s kernel once in each of its
        ``n`` TPE steps, eagerly or replayed, and the others never."""
        check_hosted(f"tpe_rest {what}", low, n, tally.graphs)

    # (a) the hosted joint step at full width.
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = synthetic_trials(domain.cs, N_HISTORY, 0, dev)
    tid = trials.new_trial_ids(1)

    def step(s):
        return tpe.suggest_batch(tid, domain, trials, s, **mv)

    times = []
    for s in range(6):
        t0 = time.perf_counter()
        vals, _ = counted("f32", lambda: step(s))
        times.append((time.perf_counter() - t0) * 1e3)
        only(f"(a) step {s}", "f32", 1)
        bad = in_bounds(cs, vals[0])
        if bad:
            fail(f"tpe_rest (a): proposal outside the space: {bad}")
    steady_ms = float(np.median(times[1:]))
    prof = counted("f32", lambda: profile_steps(
        lambda s: step(100 + s), label="tpe_rest (a) joint step"))
    only("(a) profiled steps", "f32", 3)
    print(f"tpe_rest (a): joint step at P={cs.n_params}, history "
          f"{N_HISTORY}, n_cand {N_CAND}: first_ms={times[0]:.2f} "
          f"steady_ms_median={steady_ms:.2f}, K1 once per step; profiled "
          f"wall {prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, "
          f"share {prof['share']:.3f}, {prof['kernels']:.1f} kernels per "
          f"step; the factorized step in this run: steady "
          f"{hosted['steady_ms']:.2f} ms, busy {hosted['busy_ms']:.3f} ms, "
          f"share {hosted['share']:.3f}, {hosted['kernels']:.1f} kernels")
    small = compile_space(flagship_space(10))
    hist = tpe._padded_history(synthetic_trials(small, 50, 1, "cpu")
                               .history(small), 64)
    rows, noise = [], None
    for d in (torch.device("cpu"), dev):
        kern = tpe.get_kernel(small, 64, 128, 25, device=d,
                              multivariate=True)
        if noise is None:
            noise = kern.draw_noise(torch.Generator().manual_seed(0))
        nz = {"cont": [(a.to(d), b.to(d)) for a, b in noise["cont"]],
              "cat": noise["cat"].to(d)}
        row, _ = kern(*[torch.as_tensor(a, device=d) for a in hist], 0.25,
                      1.0, noise=nz)
        rows.append(row.cpu())
    if not torch.allclose(rows[0], rows[1], rtol=1e-5, atol=1e-5):
        fail(f"tpe_rest (a): card and CPU joint steps propose different "
             f"rows:\n{rows[1]}\n{rows[0]}")
    print("tpe_rest (a): card and CPU joint rows agree on the small step")

    # (b) device mode, joint: 16 trials at stride 1 after the history equal
    # the hosted joint run's; 256 from empty, one capture, K1 once per
    # replay; card ms per replay beside the factorized step's, in turns.
    history0 = synthetic_trials(cs, N_HISTORY, 1, dev)

    def copy_history():
        return base.trials_from_docs(copy.deepcopy(list(history0)))

    n_total = N_HISTORY + REST_MORE
    th = copy_history()
    counted("f32", lambda: ho.fmin(
        objective_f32, space, algo=algo_mv, max_evals=n_total, trials=th,
        rstate=np.random.default_rng(4), device=dev,
        show_progressbar=False))
    only("(b) hosted joint run", "f32", REST_MORE)
    obj_b = make_objective_torch()
    td = counted("f32", lambda: device_fmin(
        obj_b, space, algo_mv, copy_history(), n_total, 1, dev, 4))
    check_counters("tpe_rest (b) stride 1", captures=1, replays=REST_MORE,
                   eager_steps=0, fetch_syncs=REST_MORE)
    check_captures("tpe_rest (b) stride 1", "f32")
    diffs = column_diffs(landed(td, N_HISTORY), landed(th, N_HISTORY))
    if diffs or len(td) != n_total:
        fail(f"tpe_rest (b): joint device and hosted trials differ: {diffs}")
    # The factorized step's graph at the same bucket, for the card ms per
    # replay after the 1,000 rows, in turns.
    obj_bf = make_objective_torch()
    counted("f32", lambda: device_fmin(obj_bf, space, algo_fac,
                                       copy_history(), n_total, 1, dev, 4))
    check_counters("tpe_rest (b) factorized stride 1", captures=1,
                   replays=REST_MORE, eager_steps=0)
    h1k = th.history(cs)
    seg_b = {"joint": segment_of(cs, obj_b, tpe._bucket(n_total)),
             "factorized": segment_of(cs, obj_bf, tpe._bucket(n_total))}
    card_1k = {"joint": [], "factorized": []}
    for label in ("joint", "factorized", "factorized", "joint"):
        _, ms = counted("f32", lambda: replay_ms(seg_b[label], h1k,
                                                 N_HISTORY))
        card_1k[label].append(ms)
    print(f"tpe_rest (b): {REST_MORE} joint trials after {N_HISTORY} at "
          f"sync_stride=1 equal the hosted joint run's (misc.vals, "
          f"losses); card ms per replay after {N_HISTORY} rows (bucket "
          f"{seg_b['joint'].n_cap}, in turns joint, factorized, factorized, "
          f"joint): joint {card_1k['joint'][0]:.4f}/"
          f"{card_1k['joint'][1]:.4f}, factorized "
          f"{card_1k['factorized'][0]:.4f}/{card_1k['factorized'][1]:.4f}; "
          f"pool bytes joint {seg_b['joint'].pool_bytes}, factorized "
          f"{seg_b['factorized'].pool_bytes}")
    obj_mv, obj_fac = make_objective_torch(), make_objective_torch()
    rates = {}
    for label, obj, algo in (("joint", obj_mv, algo_mv),
                             ("factorized", obj_fac, algo_fac)):
        t0 = time.perf_counter()
        t = counted("f32", lambda: device_fmin(obj, space, algo, ho.Trials(),
                                               REST_RUN, None, dev, 5))
        rates[label] = REST_RUN / (time.perf_counter() - t0)
        check_counters(f"tpe_rest (b) {label} capture run", captures=1,
                       replays=REST_RUN, eager_steps=0, fetch_syncs=1)
        check_captures(f"tpe_rest (b) {label} capture run", "f32")
    h256 = t.history(cs)
    t0 = time.perf_counter()
    counted("f32", lambda: device_fmin(obj_mv, space, algo_mv, ho.Trials(),
                                       REST_RUN, None, dev, 6))
    replay_rate = REST_RUN / (time.perf_counter() - t0)
    check_counters("tpe_rest (b) joint replay run", captures=0,
                   run_cache_hits=1, replays=REST_RUN, eager_steps=0)
    wall_ms, kernels = counted("f32", lambda: profiled(
        lambda: device_fmin(obj_mv, space, algo_mv, ho.Trials(), REST_RUN,
                            None, dev, 7)))
    check_counters("tpe_rest (b) profiled joint run", captures=0,
                   run_cache_hits=1, replays=REST_RUN, eager_steps=0)
    seen = kernel_counts(kernels)
    if seen != {k: REST_RUN * (k == "f32") for k in seen}:
        fail(f"tpe_rest (b): the profiler counted {seen} EI kernel runs in "
             f"{REST_RUN} joint replays")
    busy = sum(m for _, _, m in kernels)
    n_k = sum(c for _, c, _ in kernels)
    seg_mv = segment_of(cs, obj_mv, tpe._bucket(REST_RUN))
    seg_fac = segment_of(cs, obj_fac, tpe._bucket(REST_RUN))
    card = {"joint": [], "factorized": []}
    rows_in = REST_RUN - DEVICE_PROFILED
    for label, seg in (("joint", seg_mv), ("factorized", seg_fac),
                       ("factorized", seg_fac), ("joint", seg_mv)):
        _, ms = counted("f32", lambda: replay_ms(seg, h256, rows_in))
        card[label].append(ms)
    print(f"tpe_rest (b): {REST_RUN} trials from empty at stride None, "
          f"one capture each: joint {rates['joint']:.1f} trials/s, "
          f"factorized {rates['factorized']:.1f} (capture included); "
          f"joint replayed run {replay_rate:.1f} trials/s; profiled joint "
          f"run: K1 {seen['f32']} runs in {REST_RUN} replays, busy "
          f"{busy / REST_RUN:.3f} ms and {n_k / REST_RUN:.1f} kernels per "
          f"replay, share {busy / wall_ms:.3f}; card ms per replay after "
          f"{rows_in} rows (bucket {seg_mv.n_cap}, in turns joint, "
          f"factorized, factorized, joint): joint "
          f"{card['joint'][0]:.4f}/{card['joint'][1]:.4f}, factorized "
          f"{card['factorized'][0]:.4f}/{card['factorized'][1]:.4f}; pool "
          f"bytes joint {seg_mv.pool_bytes}, factorized "
          f"{seg_fac.pool_bytes}")

    # (c) joint fleet lanes and the joint cohort, per EI lowering.
    domain_c = base.Domain(objective, space)
    domain_c.cs.device = dev
    exps = [synthetic_trials(cs, 200 + 7 * j, 60 + j, dev)
            for j in range(COHORT)]
    seeds = [700 + 13 * j for j in range(COHORT)]
    ids = [t.new_trial_ids(1) for t in exps]
    n, lanes, stride = REST_FLEET_RUN, REST_LANES, FLEET_STRIDE
    for low, (name, _, _, _, tpe_kw) in KERNELS.items():
        kw = dict(mv, **tpe_kw)
        obj = make_objective_torch()
        tl = [ho.Trials() for _ in range(lanes)]
        infos = counted(low, lambda: fleet.fmin_fleet(
            obj, cs, lanes, n, seed=41, sync_stride=stride, trials_list=tl,
            device=dev, **kw))
        check_counters(f"tpe_rest (c) {low} fmin_fleet", captures=1,
                       replays=n, eager_steps=0, fetch_syncs=n // stride)
        check_captures(f"tpe_rest (c) {low} fmin_fleet", low)
        for j in range(lanes):
            t = counted(low, lambda: device_fmin(
                obj, space, partial(tpe.suggest, **kw), ho.Trials(), n,
                stride, dev, 41 + j))
            diffs = column_diffs(landed(tl[j], 0), landed(t, 0))
            solo = np.asarray([d["result"]["loss"] for d in t], np.float32)
            if diffs or len(t) != n or device.eager_steps \
                    or not np.array_equal(infos[j]["losses"], solo):
                fail(f"tpe_rest (c) {low}: joint lane {j} differs from its "
                     f"solo device run: {diffs}")
        pool = segment_of(cs, obj, tpe._bucket(n), lanes).pool_bytes
        want = [tpe.suggest(ids[j], domain_c, exps[j], seeds[j], **kw)
                for j in range(COHORT)]
        sched = fleet.CohortScheduler(**kw)
        fleet.reset_counters()
        handles = counted(low, lambda: sched.suggest_dispatch(
            [(ids[j], domain_c, exps[j], seeds[j]) for j in range(COHORT)]))
        only(f"(c) {low} cohort", low, 1)
        if fleet.dispatches != 1:
            fail(f"tpe_rest (c) {low}: {fleet.dispatches} cohort dispatches")
        got = [fleet.suggest_materialize(hd) for hd in handles]
        for j in range(COHORT):
            if got[j][0]["misc"]["vals"] != want[j][0]["misc"]["vals"]:
                fail(f"tpe_rest (c) {low}: experiment {j}'s joint cohort row "
                     f"differs from its solo tpe.suggest")
        print(f"tpe_rest (c) {low}: fmin_fleet(multivariate=True, {lanes} "
              f"lanes, {n} trials) lands each lane's solo device run bit for "
              f"bit (pool {pool} bytes); a joint CohortScheduler served "
              f"{COHORT} experiments with one launch of {name}, each row "
              f"equal to its solo tpe.suggest")

    # (d) the samplers: the Gumbel sampler captures, stays in bounds, and
    # its lanes equal their solo runs; card ms per replay of each, in turns.
    variants = (("default", {}), ("gumbel", dict(comp_sampler="gumbel")))
    lowered = {}
    for label, extra in variants:
        obj = make_objective_torch()
        algo = partial(tpe.suggest, n_EI_candidates=N_CAND, **extra)
        t = counted("f32", lambda: device_fmin(obj, space, algo, ho.Trials(),
                                               REST_RUN, None, dev, 9))
        check_counters(f"tpe_rest (d) {label}", captures=1, replays=REST_RUN,
                       eager_steps=0, fetch_syncs=1)
        check_captures(f"tpe_rest (d) {label}", "f32")
        lowered[label] = (t, segment_of(cs, obj, tpe._bucket(REST_RUN)))
    hg = lowered["gumbel"][0].history(cs)
    for row, act in zip(hg["vals"], hg["active"]):
        bad = [lab for lab in in_bounds(cs, row) if act[cs.by_label[lab].pid]]
        if bad:
            fail(f"tpe_rest (d): Gumbel proposal outside the space: {bad}")
    obj = make_objective_torch()
    gkw = dict(n_EI_candidates=N_CAND, comp_sampler="gumbel")
    infos = counted("f32", lambda: fleet.fmin_fleet(
        obj, cs, lanes, n, seed=51, sync_stride=stride, device=dev, **gkw))
    check_counters("tpe_rest (d) Gumbel fleet", captures=1, replays=n,
                   eager_steps=0)
    for j in range(lanes):
        _, solo = counted("f32", lambda: ho.fmin_device(
            obj, cs, n, seed=51 + j, device=dev, **gkw))
        for k in ("losses", "vals", "active"):
            if not np.array_equal(infos[j][k], solo[k]):
                fail(f"tpe_rest (d): Gumbel lane {j} differs from its solo "
                     f"run in {k}")
    h_d = lowered["default"][0].history(cs)
    card = {label: [] for label, _ in variants}
    order = [label for label, _ in variants]
    for label in order + order[::-1]:
        _, ms = counted("f32", lambda: replay_ms(lowered[label][1], h_d,
                                                 rows_in))
        card[label].append(ms)
    print(f"tpe_rest (d): comp_sampler='gumbel' captures, "
          f"proposes in bounds, and its {lanes} fleet lanes equal their "
          f"solo runs; card ms per replay after {rows_in} rows (in turns, "
          f"forth and back): " + ", ".join(
              f"{label} {ms[0]:.4f}/{ms[1]:.4f}" for label, ms in card.items())
          + "; pool bytes " + ", ".join(
              f"{label} {lowered[label][1].pool_bytes}" for label in order))

    # (e) startup="qmc": the card's startup rows equal the CPU's; then TPE
    # steps follow on the card; device mode refuses it.
    qalgo = partial(tpe.suggest, startup="qmc", n_EI_candidates=N_CAND)
    starts = []
    for d, n_q in ((torch.device("cpu"), 20), (dev, REST_QMC)):
        t = ho.Trials()
        counted("f32", lambda: ho.fmin(
            objective, space, algo=qalgo, max_evals=n_q, trials=t,
            rstate=np.random.default_rng(11), device=d,
            show_progressbar=False))
        if d.type == "cuda":
            only("(e) qmc-started run", "f32", REST_QMC - 20)
        starts.append([doc["misc"]["vals"] for doc in list(t)[:20]])
    if starts[0] != starts[1]:
        fail("tpe_rest (e): the card's qmc startup rows differ from the "
             "CPU's")
    try:
        ho.fmin(make_objective_torch(), space, algo=qalgo, max_evals=8,
                trials=ho.Trials(), rstate=np.random.default_rng(0),
                device=dev, mode="device", show_progressbar=False)
    except ValueError as e:
        if "host-only" not in str(e):
            fail(f"tpe_rest (e): the refusal does not say why: {e}")
    else:
        fail("tpe_rest (e): mode='device' took startup='qmc'")
    print(f"tpe_rest (e): startup='qmc' proposes the CPU's 20 startup rows "
          f"on the card, then {REST_QMC - 20} TPE steps (one K1 each); "
          f"mode='device' refuses it (ValueError)")

    # (f) suggest_quantile in the pipeline, and the step that crosses the
    # 1,024 bucket with and without the prewarm.
    history_f = list(synthetic_trials(cs, N_HISTORY, 4, dev))
    sizes = []

    def q_dispatch(new_ids, domain, trials, seed):
        hd = tpe.suggest_quantile.dispatch(new_ids, domain, trials, seed,
                                           n_EI_candidates=N_CAND)
        if hd[0] == "pending":
            sizes.append(len(new_ids))
        return hd

    def q_suggest(new_ids, domain, trials, seed):
        return tpe.suggest_quantile.materialize(
            q_dispatch(new_ids, domain, trials, seed))

    q_suggest.dispatch = q_dispatch
    for half in ("materialize", "start_transfer", "handle_ready"):
        setattr(q_suggest, half, getattr(tpe.suggest_quantile, half))
    t = ho.Trials()
    t.insert_trial_docs(copy.deepcopy(history_f))
    t.refresh()
    t0 = time.perf_counter()
    counted("f32", lambda: ho.fmin(
        objective, space, algo=q_suggest, max_evals=N_HISTORY + REST_PIPE,
        trials=t, rstate=np.random.default_rng(12), device=dev,
        overlap_depth=2, show_progressbar=False))
    q_wall = time.perf_counter() - t0
    steps = sum(tpe._batch_size_for(k) for k in sizes)
    only("(f) suggest_quantile pipeline", "f32", steps)
    check_settled("tpe_rest (f)", t)
    if steps != REST_PIPE or len(t) != N_HISTORY + REST_PIPE:
        fail(f"tpe_rest (f): {steps} TPE steps, {len(t)} trials")
    cross = {True: [], False: []}
    first = REST_BUCKET + 1 - REST_BUCKET_HISTORY    # the first past it
    hist_b = list(synthetic_trials(cs, REST_BUCKET_HISTORY, 13, dev))
    for prewarm in (True, False, True, False):
        # Each turn builds the 2,048 bucket's kernel anew, and the 1,024
        # kernel may prewarm it again.
        with tpe._KERNELS_LOCK:
            for k in list(cs._tpe_kernels):
                if k[0] == 2 * REST_BUCKET:
                    del cs._tpe_kernels[k]
                else:
                    cs._tpe_kernels[k].__dict__.pop("_prewarmed", None)
        times = []

        def timed(new_ids, domain, trials, seed):
            t0 = time.perf_counter()
            docs = tpe.suggest(new_ids, domain, trials, seed,
                               n_EI_candidates=N_CAND)
            times.append((time.perf_counter() - t0) * 1e3)
            return docs

        t = ho.Trials()
        t.insert_trial_docs(copy.deepcopy(hist_b))
        t.refresh()
        orig = tpe._prewarm_async
        if not prewarm:
            tpe._prewarm_async = lambda kern, n=1: None
        try:
            counted("f32", lambda: ho.fmin(
                objective, space, algo=timed,
                max_evals=REST_BUCKET_HISTORY + REST_BUCKET_STEPS, trials=t,
                rstate=np.random.default_rng(14), device=dev,
                show_progressbar=False))
        finally:
            tpe._prewarm_async = orig
        tpe.wait_prewarm()
        only(f"(f) bucket crossing, prewarm {prewarm}", "f32",
             REST_BUCKET_STEPS)
        cross[prewarm].append((times[first],
                               float(np.median(times[first + 1:])),
                               float(np.median(times[:first]))))
    # What the prewarm takes off the crossing step: building the 2,048
    # bucket's kernel, timed alone.
    build_ms = []
    for _ in range(3):
        with tpe._KERNELS_LOCK:
            for k in [k for k in cs._tpe_kernels if k[0] == 2 * REST_BUCKET]:
                del cs._tpe_kernels[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpe.get_kernel(cs, 2 * REST_BUCKET, N_CAND, 25, device=dev)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    fmt = "; ".join(
        f"{'with' if pw else 'without'} prewarm: " + ", ".join(
            f"first {a:.3f} steady {b:.3f} (before: {c:.3f})"
            for a, b, c in cross[pw]) for pw in (True, False))
    print(f"tpe_rest (f): suggest_quantile at overlap_depth=2, {REST_PIPE} "
          f"trials after {N_HISTORY}: {REST_PIPE / q_wall:.2f} trials/s, K1 "
          f"once per TPE step ({steps}); host ms per suggest across the "
          f"{REST_BUCKET} -> {2 * REST_BUCKET} bucket (the first step at "
          f"{REST_BUCKET + 1} rows, the steady median after it, and before "
          f"it in {REST_BUCKET}), in turns: {fmt}; building the "
          f"{2 * REST_BUCKET} kernel alone: "
          + ", ".join(f"{ms:.3f}" for ms in build_ms) + " ms")
    print(f"tpe_rest: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


# -- the other suggest heads ------------------------------------------------------


def settled_in_bounds(what, cs, trials, first):
    """No trial NEW or RUNNING, no tid twice, finite losses, and every
    active value of the trials from index ``first`` on inside its prior's
    support."""
    check_settled(what, trials)
    h = trials.history(cs)
    for row, act in zip(h["vals"][first:], h["active"][first:]):
        bad = [lb for lb in in_bounds(cs, row) if act[cs.by_label[lb].pid]]
        if bad:
            fail(f"heads {what}: a proposal lies outside the space: {bad}")


def heads_fmin(space, history0, algo, more, seed, **kw):
    """``more`` hosted trials after ``history0``, with no ``device=``: the
    entry point's default, CUDA."""
    trials = base.trials_from_docs(copy.deepcopy(history0))
    ho.fmin(objective, space, algo=algo, max_evals=N_HISTORY + more,
            trials=trials, rstate=np.random.default_rng(seed),
            show_progressbar=False, **kw)
    return trials


def heads_sync_free(head, name, space, history0, dev, n):
    """A warm full-width dispatch of ``head`` and its ``start_transfer``
    under ``set_sync_debug_mode("error")``, with 5 new rows to append and
    3 trials in flight."""
    domain, trials, more = with_new_rows(space, history0, dev)
    ids = list(range(N_HISTORY + 8, N_HISTORY + 8 + n))
    head.suggest(ids, domain, trials, 1)
    trials.insert_trial_docs(more)
    trials.refresh()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = head.suggest.dispatch(ids, domain, trials, 2)
        head.suggest.start_transfer(handle)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    if handle[0] != "pending" or not handle[3].host.is_pinned():
        fail(f"heads {name}: the dispatch's copy did not start into pinned "
             f"memory")
    docs = head.suggest.materialize(handle)
    if [d["tid"] for d in docs] != ids:
        fail(f"heads {name}: the synchronization-free dispatch lost rows")


def heads_dispatch_ms(head, name, domain, trials, n):
    """Host ms per dispatch (the enqueue) and card ms between CUDA events
    around it, medians over ``HEADS_TIMED`` warm dispatches of ``n``
    proposals; then one dispatch + fetch per step under the profiler."""
    ids = list(range(N_HISTORY, N_HISTORY + n))
    head.suggest(ids, domain, trials, 0)
    host, card = [], []
    for r in range(HEADS_TIMED):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        handle = head.suggest.dispatch(ids, domain, trials, r + 1)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        card.append(start.elapsed_time(end))
        head.suggest.materialize(handle)
    prof = profile_steps(lambda s: head.suggest(ids, domain, trials, 50 + s),
                         n=3, label=f"heads {name} n={n}")
    print(f"heads {name} n={n}: host ms per dispatch median "
          f"{np.median(host):.3f} (min {min(host):.3f}, max "
          f"{max(host):.3f}); card ms per dispatch between events median "
          f"{np.median(card):.3f} (min {min(card):.3f}, max "
          f"{max(card):.3f}); busy ms per suggest {prof['busy_ms']:.3f}, "
          f"kernels per suggest {prof['kernels']:.1f}")


def heads_rows_close(what, got, want):
    """Categorical and integer values equal, the others within 1e-5."""
    for g, w in zip(got, want):
        gv, wv = g["misc"]["vals"], w["misc"]["vals"]
        for label in wv:
            a, b = gv[label], wv[label]
            if len(a) != len(b) or (a and not math.isclose(
                    a[0], b[0], rel_tol=1e-5, abs_tol=1e-5)):
                fail(f"heads {what}: card and CPU differ at {label}: "
                     f"{a} against {b}")


def heads_gp_card_vs_cpu(small, trials, cand, dev, m=8):
    """GP's program on the card and on the CPU over one history and the
    same candidate sweeps, step by step: the grid's log marginal
    likelihoods within 1e-3 of their size (float32 Cholesky factors of
    cuSOLVER and LAPACK) and its pick equal; each liar step's pick and row
    equal, its standardized mu and sigma within 1e-2 and its EI within
    1e-2 of the best EI, while the CPU's EI separates its best two
    candidates (a lead over 5e-2 of the best, which is over 1e-6).  The
    tolerance is the float32 conditioning of the fit: with noise 1e-4 and
    a long length-scale the kernel matrix's condition number reaches
    ~1e5, and the two libraries' factors give solves that differ in the
    third digit.  After the first step whose EI does not separate (the EI
    of a confident fit underflows to 0 within a few steps), the two
    follow different lies and the comparison stops.  Returns the steps
    compared and the largest differences; the first step must be
    compared."""
    from hyperopt_tpu_torch.backends import gp

    h = trials.history(small.cs)
    n_cap = tpe._bucket(len(h["loss"]))
    hist = history._padded_history(h, n_cap)
    runs = []
    for d in (torch.device("cpu"), dev):
        prog = gp._GpProgram(small.cs, n_cap, len(cand[0][0]), m, 256, d)
        trace = []
        rows = prog(*[torch.as_tensor(a, device=d) for a in hist],
                    cand=cand, trace=trace)
        runs.append((rows.cpu(), [{k: v.cpu().double() for k, v in t.items()}
                                  for t in trace]))
    (rows_c, tc), (rows_g, tg) = runs
    diffs = {"scores": float((tc[0]["scores"] - tg[0]["scores"]).abs()
                             .max())}
    if int(tc[0]["pick"]) != int(tg[0]["pick"]) or not torch.allclose(
            tc[0]["scores"], tg[0]["scores"], rtol=1e-3, atol=1e-3):
        fail(f"heads (c) gp: grid scores {tg[0]['scores'].tolist()} on the "
             f"card against {tc[0]['scores'].tolist()}")
    agreed = 0
    for i, (c, g) in enumerate(zip(tc[1:], tg[1:])):
        top = torch.topk(c["ei"], 2).values
        if not (top[0] > 1e-6 and top[0] - top[1] > 5e-2 * top[0]):
            break
        if int(c["pick"]) != int(g["pick"]) or not torch.equal(
                rows_c[i], rows_g[i]):
            fail(f"heads (c) gp: step {i} picks {int(g['pick'])} on the "
                 f"card, {int(c['pick'])} on the CPU")
        for k, tol in (("mu", 1e-2), ("sigma", 1e-2),
                       ("ei", 1e-2 * float(top[0]))):
            d = float((c[k] - g[k]).abs().max())
            diffs[k] = max(diffs.get(k, 0.0), d)
            if d > tol:
                fail(f"heads (c) gp: step {i} {k} differs by {d:.3g}")
        agreed += 1
    if agreed == 0:
        fail("heads (c) gp: the first liar step's EI does not separate "
             "its best candidates; pick another history")
    return agreed, diffs


def phase_heads(dev):
    """The other suggest heads at full width, checks (a) to (e).  Returns
    ``({lowering: (eager launches, 0, 0)}, K1's max abs error at ATPE's and
    tpe_mv's candidate counts)``."""
    from hyperopt_tpu_torch import anneal, atpe, backends, mix
    from hyperopt_tpu_torch.backends import contract, es, gp

    atpe.set_transfer_store(None)
    metrics.set_enabled(True)
    space = flagship_space()
    cs = compile_space(space)
    history0 = list(synthetic_trials(cs, N_HISTORY, 6, dev))
    tally = Tally()
    reg = metrics.registry()
    t_phase = time.perf_counter()

    def launched(what, n):
        """The last counted run ran K1 once in each of its ``n`` steps,
        eagerly or replayed, and the other kernels never."""
        check_hosted(f"heads {what}", "f32", n, tally.graphs)

    # (a) every name resolves; 16 hosted trials per unique head, on the
    # entry point's default device.
    for name in backends.names():
        if not callable(backends.resolve(name)):
            fail(f"heads (a): {name} does not resolve to a callable")
    runs = [(name, name) for name in HEADS] + [(
        "mix", partial(mix.suggest, p_suggest=[(0.3, "rand"), (0.3, "gp"),
                                               (0.4, "tpe")]))]
    for i, (name, algo) in enumerate(runs):
        picks0 = reg.counter("backend.tpe.resolved").value
        t0 = time.perf_counter()
        trials = tally.counted("f32", partial(
            heads_fmin, space, history0, algo, HEADS_MORE, 10 + i))
        secs = time.perf_counter() - t0
        if name in TPE_FAMILY or name == "atpe":
            want = HEADS_MORE
        elif name == "mix":
            want = int(reg.counter("backend.tpe.resolved").value - picks0)
        else:
            want = 0
        launched(f"(a) {name}", want)
        settled_in_bounds(f"heads (a) {name}", cs, trials, N_HISTORY)
        print(f"heads (a) {name}: {HEADS_MORE} trials after the history in "
              f"{secs:.2f} s, K1 runs {want} ({tally.graphs['replays']} "
              f"replays of the hosted step graph)")

    # (b) ATPE, 64 trials; each arm forced once through the bandit state.
    trials = base.trials_from_docs(copy.deepcopy(history0))
    arms = atpe._portfolio(cs)
    st = atpe._state(trials, cs, len(arms))
    forced = list(range(len(arms)))
    picked0 = {k: reg.counter(f"atpe.arm.{k}.picked").value
               for k in range(len(arms))}

    def forcing(new_ids, domain, trials, seed):
        k = forced.pop(0) if forced else None
        if k is not None:
            st.wins[k] += 1e12
        try:
            return atpe.suggest(new_ids, domain, trials, seed)
        finally:
            if k is not None:
                st.wins[k] -= 1e12

    t0 = time.perf_counter()
    tally.counted("f32", lambda: ho.fmin(
        objective, space, algo=forcing, max_evals=N_HISTORY + HEADS_ATPE,
        trials=trials, rstate=np.random.default_rng(20),
        show_progressbar=False))
    secs = time.perf_counter() - t0
    launched("(b) atpe", HEADS_ATPE)
    settled_in_bounds("heads (b) atpe", cs, trials, N_HISTORY)
    picks = {k: int(reg.counter(f"atpe.arm.{k}.picked").value - picked0[k])
             for k in range(len(arms))}
    if min(picks.values()) < 1 or sum(picks.values()) != HEADS_ATPE:
        fail(f"heads (b): ATPE arm picks {picks}")
    cands = sorted({a["n_EI_candidates"] for a in arms})
    print(f"heads (b) atpe: {HEADS_ATPE} trials in {secs:.2f} s, arm picks "
          f"{picks}, arms' candidate counts {cands}, K1 launches "
          f"{HEADS_ATPE}, wins {st.wins.tolist()}")
    rng = np.random.default_rng(3)
    below = random_mixture(rng, 31, 26, 25, dev)
    above = random_mixture(rng, 31, 1025, 1022, dev)
    err_max = 0.0
    for n_cand in HEADS_K1_CANDIDATES:
        z = torch.as_tensor(rng.normal(0, 3, (31, n_cand)).astype(np.float32),
                            device=dev)
        got = ei_mod.ei_scores(z, *below, *above)
        torch.cuda.synchronize()
        ref = ei_mod.ei_scores_reference(z, *below, *above)
        err, used, near = compare(got, ref, f"heads K1 31x{n_cand}",
                                  TOL["f32"])
        err_max = max(err_max, err)
        ms = cuda_ms(lambda: ei_mod.ei_scores(z, *below, *above))
        plain = cuda_ms(lambda: ei_mod.ei_scores_reference(z, *below, *above))
        bound, by = ei_bound_ms(z, below[0], above[0], "f32")
        print(f"heads K1 31x{n_cand} (K_b=26, K_a=1025, bucket 1,024): "
              f"max_abs_err={err:.3g} tol_used={used:.3g} "
              f"near_tie_columns={near} kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bound:.4f} ({by})")

    # (c) GP and ES: card and host ms per dispatch; synchronization-free
    # dispatches; card rows equal CPU rows on the same draws.
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = base.trials_from_docs(copy.deepcopy(history0))
    for head, name in ((gp, "gp"), (es, "es")):
        for n in (1, 8):
            heads_dispatch_ms(head, name, domain, trials, n)
            heads_sync_free(head, name, space, history0, dev, n)
        print(f"heads (c) {name}: warm dispatches of 1 and 8 and their "
              f"start_transfer ran under set_sync_debug_mode('error')")
    # One space, one history: the calls switch the space's device.
    small = contract.conformance_domain(dev)
    small_trials = contract.seeded_trials(small, n=40, seed=1)
    cand = [small.cs.sample(32, generator=make_generator("cpu", i),
                            device="cpu") for i in range(8)]
    eps = torch.randn((4, small.cs.n_params),
                      generator=make_generator("cpu", 5))
    ids = list(range(40, 48))
    small.cs.device = "cpu"
    want = es.suggest(ids, small, small_trials, 3, noise=eps)
    small.cs.device = dev
    heads_rows_close("(c) es", es.suggest(ids, small, small_trials, 3,
                                          noise=eps), want)
    agreed, diffs = heads_gp_card_vs_cpu(small, small_trials, cand, dev)
    print(f"heads (c): es (8 proposals) on the card equals the CPU's rows "
          f"on the same eps; gp (8 liar steps, 32 candidates each) equals "
          f"the CPU's grid pick and rows for its first {agreed} steps, up "
          f"to the first whose EI no longer separates its best two "
          f"candidates; largest differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))

    # (d) anneal: a batch of 8 in one call, card against CPU on one noise.
    noise = anneal._get_kernel(cs, torch.device("cpu")).draw_noise(
        8, make_generator("cpu", 8))
    ids = list(range(N_HISTORY, N_HISTORY + 8))
    cs.device = "cpu"
    want = anneal.suggest(ids, domain, trials, 4, noise=noise)
    cs.device = dev
    t0 = time.perf_counter()
    got = anneal.suggest(ids, domain, trials, 4, noise=noise)
    ms = (time.perf_counter() - t0) * 1e3
    heads_rows_close("(d) anneal", got, want)
    prof = profile_steps(lambda s: anneal.suggest(ids, domain, trials, s),
                         n=3, label="heads anneal n=8")
    print(f"heads (d) anneal: a batch of 8 in one call, {ms:.3f} ms, card "
          f"rows equal the CPU's on the same noise; busy ms "
          f"{prof['busy_ms']:.3f}, kernels {prof['kernels']:.1f}")

    # (e) the conformance suite on the card, and depth-2 GP and ES runs.
    t0 = time.perf_counter()
    for name in HEADS:
        out = contract.run_conformance(backends.resolve(name), device=dev)
        if set(out) != set(contract.CONFORMANCE_CHECKS):
            fail(f"heads (e): {name} conformance {out}")
    print(f"heads (e): run_conformance passed for {len(HEADS)} heads on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    for name in ("gp", "es"):
        trials = heads_fmin(space, history0, name, HEADS_MORE, 30,
                            overlap_depth=2)
        settled_in_bounds(f"heads (e) {name} depth 2", cs, trials, N_HISTORY)
    print(f"heads (e): fmin(overlap_depth=2) with gp and es, "
          f"{HEADS_MORE} trials each after the history")
    print(f"heads: EI wrapper over the phase's counted runs: eager launches "
          f"{tally.launches}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return tally.rows(), err_max


def dispatch_ms(domain, trials, n=DISPATCH_TIMED):
    """Host ms of ``tpe.suggest_dispatch`` (the enqueue, with the card idle
    when it starts) and card-inclusive ms through ``suggest_materialize``,
    medians over ``n`` one-proposal dispatches on the warm kernel."""
    enq, total = [], []
    for s in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = tpe.suggest_dispatch(trials.new_trial_ids(1), domain,
                                      trials, 100 + s, n_EI_candidates=N_CAND)
        t1 = time.perf_counter()
        tpe.suggest_materialize(handle)
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        total.append((t2 - t0) * 1e3)
    return float(np.median(enq)), float(np.median(total))


def phase_dispatch(dev):
    """The dispatch substrate at full width, checks (a) to (h).  Returns
    ``{lowering: (eager launches, launches recorded into graphs, replays
    of graphs that hold the kernel)}`` over its runs."""
    from hyperopt_tpu_torch import dispatch
    from hyperopt_tpu_torch.obs import export, slo, timeseries
    from hyperopt_tpu_torch.parallel import FileTrials, multihost

    t_phase = time.perf_counter()
    space = flagship_space()
    cs = compile_space(space)
    algo = partial(tpe.suggest, n_EI_candidates=N_CAND)
    history0 = synthetic_trials(cs, N_HISTORY, 1, dev)
    tally = Tally()
    counted = tally.counted
    reg = metrics.registry()

    def n_sharded():
        return reg.snapshot()["counters"].get("dispatch.sharded", 0.0)

    def copy_history():
        return base.trials_from_docs(copy.deepcopy(list(history0)))

    # (a) a world-1 NCCL group and its (1, 1) CUDA mesh, registered.
    import torch.distributed as dist

    mesh = multihost.initialize()
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda" \
            or tuple(mesh.shape) != (1, 1) \
            or dispatch.active_mesh() is not mesh:
        fail(f"dispatch (a): backend {dist.get_backend()}, mesh "
             f"{mesh.device_type} {tuple(mesh.shape)}, registered "
             f"{dispatch.active_mesh() is mesh}")
    print(f"dispatch (a): multihost.initialize(): {dist.get_backend()} "
          f"world of {dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
          f"{tuple(mesh.shape)} on {mesh.device_type}, registered")
    try:
        # (b) 16 hosted trials through plain tpe.suggest under the mesh,
        # against 16 under set_mode("local").
        n_total = N_HISTORY + DISPATCH_MORE
        runs = {}
        for name in ("sharded", "local"):
            prev = dispatch.set_mode("local" if name == "local" else "auto")
            try:
                t = copy_history()
                s0 = n_sharded()
                counted("f32", lambda: ho.fmin(
                    objective, space, algo=algo, max_evals=n_total,
                    trials=t, rstate=np.random.default_rng(7), device=dev,
                    show_progressbar=False))
                runs[name] = (landed(t, N_HISTORY), n_sharded() - s0,
                              (dict(ei_mod.ei_scores.launches_by),
                               dict(ei_mod.ei_scores.recorded_by)),
                              tally.graphs)
            finally:
                dispatch.set_mode(prev)
        (rows_s, n_s, k_s, g_s), (rows_l, n_l, k_l, g_l) = \
            runs["sharded"], runs["local"]
        if n_s != DISPATCH_MORE or n_l != 0:
            fail(f"dispatch (b): dispatch.sharded counted {n_s} and {n_l}, "
                 f"wanted {DISPATCH_MORE} and 0")
        if rows_s != rows_l:
            fail("dispatch (b): the sharded hosted run landed other rows "
                 "than the local one")
        # The sharded kernel never takes the hosted step graph.
        if g_s["replays"] or g_s["captures"]:
            fail(f"dispatch (b): the sharded run took the hosted step "
                 f"graph: {g_s}")
        check_hosted("dispatch (b) sharded", "f32", DISPATCH_MORE, g_s, k_s)
        check_hosted("dispatch (b) local", "f32", DISPATCH_MORE, g_l, k_l)
        domain = base.Domain(objective, space)
        domain.cs.device = dev
        t = copy_history()
        ms = {"sharded": [], "local": []}
        for turn in range(2):
            for name in ("sharded", "local"):
                prev = dispatch.set_mode("local" if name == "local"
                                         else "auto")
                try:
                    ms[name].append(dispatch_ms(domain, t))
                finally:
                    dispatch.set_mode(prev)
        enq = {k: float(np.median([a for a, _ in v])) for k, v in ms.items()}
        tot = {k: float(np.median([b for _, b in v])) for k, v in ms.items()}
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = tpe.suggest_dispatch(t.new_trial_ids(1), domain, t, 3,
                                          n_EI_candidates=N_CAND)
            tpe.suggest_start_transfer(handle)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        tpe.suggest_materialize(handle)
        print(f"dispatch (b): {DISPATCH_MORE} hosted trials under the mesh "
              f"land the local run's rows bit for bit; dispatch.sharded="
              f"{n_s}; K1 launches {k_s[0]['f32']} (sharded) and "
              f"{k_l[0]['f32']} (local, {g_l['replays']} replays of the "
              f"hosted step graph); host ms per dispatch (enqueue) sharded="
              f"{enq['sharded']:.3f} local={enq['local']:.3f} (collective "
              f"{enq['sharded'] - enq['local']:+.3f}); ms through "
              f"materialize sharded={tot['sharded']:.3f} "
              f"local={tot['local']:.3f}; a warm sharded dispatch and its "
              f"start_transfer ran under set_sync_debug_mode('error')")

        # (c) each kernel's scores do not depend on how the candidates are
        # split: halves and quarters equal the full launch bit for bit.
        rng = np.random.default_rng(3)
        below = random_mixture(rng, 31, 26, 25, dev)
        above = random_mixture(rng, 31, 1025, 1022, dev)
        z = torch.as_tensor(rng.normal(0, 3, (31, N_CAND)).astype(
            np.float32), device=dev)
        for low, (_, _, _, kw, _) in KERNELS.items():
            full = ei_mod.ei_scores(z, *below, *above, **kw)
            for shards in (2, 4):
                w = N_CAND // shards
                parts = torch.cat([ei_mod.ei_scores(
                    z[:, i * w:(i + 1) * w].contiguous(), *below, *above,
                    **kw) for i in range(shards)], dim=1)
                if not torch.equal(parts, full):
                    diff = (parts - full).abs().max().item()
                    fail(f"dispatch (c): {low} on {shards} slices differs "
                         f"from the full launch by {diff:.3g}")
            print(f"dispatch (c): {low}: 31x{N_CAND} scored whole, in 2 "
                  f"and in 4 candidate slices: bit-identical")

        # (d) fmin_device(mesh=): one run of 1,000 trials from empty, the
        # NCCL all-gather inside the captured graph; then 8 runs over dp.
        obj = make_objective_torch()
        timed = {}
        for name, m in (("mesh", mesh), ("none", None)):
            t0 = time.perf_counter()
            _, info = counted("f32", lambda: ho.fmin_device(
                obj, space, DISPATCH_RUN, seed=11, n_EI_candidates=N_CAND,
                mesh=m, device=dev))
            timed[name] = (info, time.perf_counter() - t0,
                           device.eager_steps, device.captures)
        (im, sm, eager, caps), (inone, snone, _, _) = timed["mesh"], \
            timed["none"]
        if eager != 0 or caps != 1:
            fail(f"dispatch (d): fmin_device(mesh=) ran {eager} eager steps "
                 f"and {caps} captures, wanted 0 and 1")
        if not all(np.array_equal(im[k], inone[k])
                   for k in ("vals", "losses", "active")):
            fail("dispatch (d): fmin_device(mesh=) landed other trials than "
                 "without the mesh")
        warm = {}
        for name, m in (("mesh", mesh), ("none", None)):
            t0 = time.perf_counter()
            counted("f32", lambda: ho.fmin_device(
                obj, space, DISPATCH_RUN, seed=12, n_EI_candidates=N_CAND,
                mesh=m, device=dev))
            warm[name] = DISPATCH_RUN / (time.perf_counter() - t0)
        _, multi = counted("f32", lambda: ho.fmin_device(
            obj, space, DISPATCH_RUNS_TRIALS, seed=20,
            n_EI_candidates=N_CAND, n_runs=DISPATCH_RUNS, mesh=mesh,
            device=dev))
        _, plain = counted("f32", lambda: ho.fmin_device(
            obj, space, DISPATCH_RUNS_TRIALS, seed=20,
            n_EI_candidates=N_CAND, n_runs=DISPATCH_RUNS, device=dev))
        for j in (0, DISPATCH_RUNS - 1):
            _, solo = counted("f32", lambda: ho.fmin_device(
                obj, space, DISPATCH_RUNS_TRIALS, seed=20 + j,
                n_EI_candidates=N_CAND, device=dev))
            if not np.array_equal(multi["vals"][j], solo["vals"]):
                fail(f"dispatch (d): run {j} of fmin_device(n_runs="
                     f"{DISPATCH_RUNS}, mesh=) differs from its solo run")
        if not all(np.array_equal(multi[k], plain[k])
                   for k in ("vals", "losses")):
            fail("dispatch (d): fmin_device(n_runs=, mesh=) differs from "
                 "the run without the mesh")
        print(f"dispatch (d): fmin_device(mesh=) {DISPATCH_RUN} trials "
              f"from empty: the trials of the run without the mesh, "
              f"eager_steps=0, 1 capture (the all-gather in the graph); "
              f"cold trials/s mesh={DISPATCH_RUN / sm:.1f} "
              f"none={DISPATCH_RUN / snone:.1f}; warm trials/s "
              f"mesh={warm['mesh']:.1f} none={warm['none']:.1f}; "
              f"n_runs={DISPATCH_RUNS} over dp=1 ({DISPATCH_RUNS_TRIALS} "
              f"trials): every run equals the unmeshed runs, runs 0 and "
              f"{DISPATCH_RUNS - 1} their solo runs")

        # (e) fmin_fleet(mesh=), 8 lanes, against the unmeshed fleet.
        fl = {name: counted("f32", lambda: ho.fleet.fmin_fleet(
            obj, space, DISPATCH_LANES, DISPATCH_RUNS_TRIALS, seed=30,
            n_EI_candidates=N_CAND, mesh=m, device=dev))
            for name, m in (("mesh", mesh), ("none", None))}
        if not all(lane_infos_equal(a, b)
                   for a, b in zip(fl["mesh"], fl["none"])):
            fail("dispatch (e): fmin_fleet(mesh=) lanes differ from the "
                 "unmeshed fleet's")
        print(f"dispatch (e): fmin_fleet(mesh=) {DISPATCH_LANES} lanes x "
              f"{DISPATCH_RUNS_TRIALS} trials equal the unmeshed fleet's")

        # (f) multi-start: K = 8 proposals from one step, one K1 launch
        # over 31·8 columns.
        shapes = []
        real = tpe.ei_scores

        def spy(z, *a, **k):
            shapes.append(tuple(z.shape))
            return real(z, *a, **k)

        t = copy_history()
        domain = base.Domain(objective, space)
        domain.cs.device = dev
        ids = t.new_trial_ids(DISPATCH_STARTS)
        tpe.ei_scores = spy
        try:
            docs = counted("f32", lambda: dispatch.multi_start_suggest(
                ids, domain, t, 41, mesh=mesh, n_EI_candidates=N_CAND))
        finally:
            tpe.ei_scores = real
        launched = ei_mod.ei_scores.launches_by["f32"]
        rows = np.stack([[d["misc"]["vals"][p.label][0]
                          if d["misc"]["vals"][p.label] else 0.0
                          for p in cs.params] for d in docs])
        act = cs.active_mask_host(rows)
        bad = [[lb for lb in in_bounds(cs, r) if a[cs.by_label[lb].pid]]
               for r, a in zip(rows, act)]
        if launched != 1 or shapes != [(31 * DISPATCH_STARTS, N_CAND)] \
                or any(bad) or len({r.tobytes() for r in rows}) \
                != DISPATCH_STARTS:
            fail(f"dispatch (f): {launched} K1 launches over {shapes}, "
                 f"out of bounds {bad}, "
                 f"{len({r.tobytes() for r in rows})} distinct rows")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        card = []
        for s in range(5):
            start.record()
            dispatch.multi_start_suggest(ids, domain, t, 50 + s, mesh=mesh,
                                         n_EI_candidates=N_CAND)
            end.record()
            end.synchronize()
            card.append(start.elapsed_time(end))
        print(f"dispatch (f): multi_start_suggest K={DISPATCH_STARTS}: "
              f"{DISPATCH_STARTS} distinct in-bounds rows, one K1 launch "
              f"over {shapes[0][0]}x{shapes[0][1]}; ms per call (CUDA "
              f"events around the call) {float(np.median(card)):.3f}")

        # (g) run_driver over a FileTrials in a temp dir, two worker
        # processes.  The workers unpickle the objective by reference, so
        # it comes from this file imported as a module (this run's
        # ``__main__`` does not exist in theirs).
        import chip_smoke

        root = tempfile.mkdtemp(prefix="chip_smoke_store_")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        workers = [subprocess.Popen(
            [sys.executable, "-m", "hyperopt_tpu_torch.parallel.filestore",
             "--root", root, "--exp-key", "mh", "--reserve-timeout", "20",
             "--poll-interval", "0.01"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _ in range(DISPATCH_WORKERS)]
        n_drive = tpe._default_n_startup_jobs + DISPATCH_DRIVER
        try:
            s0 = n_sharded()
            t0 = time.perf_counter()
            counted("f32", lambda: multihost.run_driver(
                chip_smoke.objective, space, store_root=root, exp_key="mh",
                max_evals=n_drive, mesh=mesh, n_EI_candidates=N_CAND,
                rstate=np.random.default_rng(5), show_progressbar=False,
                device=dev))
            drive_s = time.perf_counter() - t0
            k1 = ei_mod.ei_scores.launches_by["f32"]
            g_drive = tally.graphs
            n_s = n_sharded() - s0
        finally:
            outs = []
            for p in workers:
                try:
                    outs.append(p.communicate(timeout=120))
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate())
        for p, (_, err) in zip(workers, outs):
            if p.returncode != 0:
                fail(f"dispatch (g): a worker exited {p.returncode}:\n"
                     f"{err[-2000:]}")
        ft = FileTrials(root, exp_key="mh")
        tids = [d["tid"] for d in ft]
        owners = {d["owner"] for d in ft}
        for d in ft:
            with open(ft._claim_path(d["tid"])) as f:
                if f.read() != d["owner"]:
                    fail(f"dispatch (g): trial {d['tid']} claimed twice")
        n_s = int(n_s)
        if len(ft) != n_drive or len(set(tids)) != n_drive or any(
                d["state"] != base.JOB_STATE_DONE for d in ft):
            fail(f"dispatch (g): {len(ft)} trials, {len(set(tids))} tids, "
                 f"states {sorted({d['state'] for d in ft})}")
        if k1 != DISPATCH_DRIVER or n_s != DISPATCH_DRIVER \
                or g_drive["replays"] or g_drive["captures"]:
            fail(f"dispatch (g): {k1} K1 launches, {n_s} sharded "
                 f"dispatches and hosted graphs {g_drive} for "
                 f"{DISPATCH_DRIVER} TPE trials")
        shutil.rmtree(root, ignore_errors=True)
        print(f"dispatch (g): run_driver over a FileTrials with "
              f"{DISPATCH_WORKERS} worker processes: {n_drive} trials DONE "
              f"({DISPATCH_DRIVER} after startup, {n_s} sharded suggests, "
              f"K1 {k1} times on the card), {len(owners)} owners, no tid "
              f"claimed twice, {drive_s:.1f} s")

        # (h) the obs tier: a device-mode run backfills a time-series
        # store; OpenMetrics round-trips; the default SLOs evaluate.
        ts = timeseries.TimeSeriesStore(reg)
        devtel.set_backfill_store(ts)
        try:
            t = ho.Trials()
            counted("f32", lambda: device_fmin(
                make_objective_torch(), space, algo, t, DISPATCH_OBS_RUN,
                DISPATCH_OBS_RUN // 4, dev, 9))
        finally:
            devtel.set_backfill_store(None)
        names = set(ts.series_names())
        need = {f"device.segments.solo.{DISPATCH_OBS_RUN // 4}",
                "device.telemetry.best_loss", "device.telemetry.segment_ms"}
        win = ts.window_state("device.telemetry.segment_ms", 3600.0)
        if ts.n_scrapes != 4 or not need <= names or win["count"] < 4:
            fail(f"dispatch (h): {ts.n_scrapes} scrapes, missing "
                 f"{sorted(need - names)}, window {win}")
        text = export.render_openmetrics(reg.snapshot(states=True))
        fams = export.parse_openmetrics(text)
        mon = slo.SloMonitor(slo.default_slos(), ts)
        status = mon.evaluate()
        print(f"dispatch (h): {ts.n_scrapes} back-dated scrapes, "
              f"{len(names)} series ({ts.nbytes()} bytes est.); "
              f"OpenMetrics of the registry: {len(fams)} families, "
              f"{len(text)} bytes, round-trips; default SLOs: "
              f"{[(s['name'], s['firing']) for s in status]}")
    finally:
        dispatch.clear_default_mesh()
        dist.destroy_process_group()
    print(f"dispatch: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}; {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


def entry_sheets(kern, noise, vals, active, loss, ok):
    """Each column's EI sheet in one ``graft_entry_torch.entry`` step:
    ``[(pids, ei[C, n_cand])]`` per continuous group, then the
    categorical sheet."""
    below, above = kern._split(loss, ok, graft.GAMMA)
    out = []
    for g, gt, (uc, u) in zip(kern.groups, kern._gt, noise["cont"]):
        _, ei = kern._cont_scores(g, gt, vals, active, below, above,
                                  graft.PRIOR_WEIGHT, uc, u)
        out.append((gt.pids, ei.cpu()))
    if len(kern.cat_pids):
        _, score = kern._cat_scores(noise["cat"], vals, active, below, above,
                                    graft.PRIOR_WEIGHT)
        out.append((kern._cat.pids, score.cpu()))
    return out


def rows_near_equal(what, got, want, sheets_got, sheets_want):
    """The card's row ``got`` against the CPU's ``want``: where a column's
    EI argmax agrees the values agree (exactly for integer columns, else
    to 1e-5), and where it differs the CPU scores the two winners within
    ``MARGIN``.  The sheets are not held to each other elementwise: the
    card's and the CPU's candidates differ in the last bits of their
    draws (3.05e-5 at most in this step on an H100), which moves EI by up
    to ~3e-4; :func:`entry_k1_calls` holds K1 itself to its plain version
    on the card's own rows.  Returns the number of near-tie columns."""
    cs = compile_space(graft._flagship_space())
    near = 0
    for (pids, eg), (_, ec) in zip(sheets_got, sheets_want):
        ig, ic = eg.argmax(-1), ec.argmax(-1)
        for j, pid in enumerate(pids.tolist()):
            g, w = float(got[pid]), float(want[pid])
            if ig[j] != ic[j]:
                gap = float(ec[j, ic[j]] - ec[j, ig[j]])
                if gap > MARGIN:
                    fail(f"{what}: column {cs.params[pid].label} picks "
                         f"candidate {int(ig[j])} on the card and "
                         f"{int(ic[j])} on the CPU, EI gap {gap:.3g}")
                near += 1
            elif (g != w) if cs.params[pid].is_int else \
                    abs(g - w) > 1e-5 * max(1.0, abs(w)):
                fail(f"{what}: column {cs.params[pid].label} is {g!r} on "
                     f"the card and {w!r} on the CPU")
    return near


def entry_k1_calls(fn, args):
    """Run ``fn(*args)`` once with ``tpe.ei_scores`` spied on: each K1
    call of the step as ``(rows, kwargs, out)``, the rows as the path
    hands them to the kernel."""
    calls = []
    real = tpe.ei_scores

    def spy(*rows, **kw):
        out = real(*rows, **kw)
        calls.append((rows, kw, out))
        return out

    tpe.ei_scores = spy
    try:
        fn(*args)
    finally:
        tpe.ei_scores = real
    return calls


def phase_contract(dev):
    """``graft_entry_torch``'s entry points on the card: (a) ``entry()``'s
    step eagerly (K1 once), (b) the same ``fn`` captured in a CUDA graph
    (K1 recorded once) and replayed ``CONTRACT_REPLAYS`` times, each replay
    equal to the eager row bit for bit and running K1 (profiler), (c) K1
    held to its plain version by :func:`compare` on the rows the step
    hands it, and the card's row and mask against the CPU's from the same
    uniforms with the near-tie rule, (d) ``dryrun_multichip(1)`` on a
    world-1 NCCL mesh.  Returns
    ``{lowering: (eager launches, launches recorded into graphs, replays
    of graphs that hold the kernel)}``."""
    from hyperopt_tpu_torch import dispatch

    t_phase = time.perf_counter()
    tally = Tally()
    # (a) the step, eagerly.
    fn, args = graft.entry()
    t0 = time.perf_counter()
    row, act = tally.counted("f32", lambda: fn(*args))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    if tally.launches != {"f32": 1, "bf16": 0, "mxu": 0}:
        fail(f"contract (a): the eager step launched {tally.launches}")
    if tuple(row.shape) != (53,) or tuple(act.shape) != (53,) \
            or not bool(torch.isfinite(row[act]).all()):
        fail(f"contract (a): row {tuple(row.shape)}, act "
             f"{tuple(act.shape)}, finite "
             f"{bool(torch.isfinite(row[act]).all())}")
    step_ms = cuda_ms(lambda: fn(*args), reps=10, warmup=2, inner=1)
    print(f"contract (a): entry() step on the card: row/act (53,), K1 "
          f"once; first call {eager_ms:.2f} ms wall, steady "
          f"{step_ms:.3f} ms by CUDA events")

    # (b) captured once, replayed CONTRACT_REPLAYS times.
    graph, (g_row, g_act) = tally.counted(
        "f32", lambda: graft.capture(fn, args))
    if ei_mod.ei_scores.recorded_by != {"f32": 1, "bf16": 0, "mxu": 0} \
            or ei_mod.ei_scores.launches_by["f32"] != 2:
        fail(f"contract (b): the capture launched "
             f"{ei_mod.ei_scores.launches_by} and recorded "
             f"{ei_mod.ei_scores.recorded_by}")
    for i in range(CONTRACT_REPLAYS):
        g_row.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not (torch.equal(g_row, row) and torch.equal(g_act, act)):
            fail(f"contract (b): replay {i} differs from the eager row")
    tally.replayed["f32"] += CONTRACT_REPLAYS
    _, kernels = profiled(lambda: [graph.replay()
                                   for _ in range(CONTRACT_REPLAYS)])
    tally.replayed["f32"] += CONTRACT_REPLAYS
    ran = kernel_counts(kernels)
    if ran != {"f32": CONTRACT_REPLAYS, "bf16": 0, "mxu": 0}:
        fail(f"contract (b): {CONTRACT_REPLAYS} profiled replays ran the EI "
             f"kernels {ran}")
    replay_ms = cuda_ms(graph.replay, reps=10, warmup=2, inner=1)
    print(f"contract (b): captured once (2 warm-up launches, K1 recorded "
          f"once); {CONTRACT_REPLAYS} replays equal the eager row and mask "
          f"bit for bit; K1 ran {ran['f32']} times in {CONTRACT_REPLAYS} "
          f"profiled replays; {replay_ms:.3f} ms per replay against "
          f"{step_ms:.3f} ms per eager step (CUDA events)")

    # (c) K1 against its plain version on the rows the step hands it;
    # the card's row and mask against the CPU's from the same uniforms.
    calls = entry_k1_calls(fn, args)
    if len(calls) != 1:
        fail(f"contract (c): the step called K1 {len(calls)} times")
    ((rows, kw, got),) = calls
    ref = ei_mod.ei_scores_reference(*rows, **kw)
    err, used, k1_near = compare(got, ref, "contract (c) K1", TOL["f32"])
    fn_c, args_c = graft.entry(device="cpu")
    row_c, act_c = fn_c(*args_c)
    if not torch.equal(act.cpu(), act_c):
        fail("contract (c): the card's activity mask differs from the CPU's")
    cs = compile_space(graft._flagship_space())
    sheets = [entry_sheets(tpe.get_kernel(cs, 128, 1024, 25, device=d), *a)
              for d, a in ((dev, args), (torch.device("cpu"), args_c))]
    near = rows_near_equal("contract (c)", row.cpu(), row_c, *sheets)
    print(f"contract (c): K1 at entry()'s shape {tuple(rows[0].shape)} "
          f"(K_b={rows[1].shape[1]}, K_a={rows[4].shape[1]}) against its "
          f"plain version on the same rows: max_abs_err={err:.3g} "
          f"tol={TOL['f32']:g} tol_used={used:.3g} "
          f"near_tie_columns={k1_near}; the card's row and mask equal the "
          f"CPU's from the same uniforms ({near} near-tie columns, EI gap "
          f"<= {MARGIN})")

    # (d) the mesh step on a world-1 NCCL group.
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        tally.counted("f32", lambda: graft.dryrun_multichip(1))
    dry_s = time.perf_counter() - t0
    text = out.getvalue()
    print("".join(f"  | {line}\n" for line in text.splitlines()), end="")
    need = ("nccl on cuda", "mesh={'dp': 1, 'sp': 1}", "trials evaluated",
            "global mesh OK")
    missing = [n for n in need if n not in text]
    if missing or dispatch.active_mesh() is not None:
        fail(f"contract (d): dryrun_multichip(1) printed no {missing}, "
             f"mesh left {dispatch.active_mesh()}")
    print(f"contract (d): dryrun_multichip(1) on NCCL in {dry_s:.2f} s: "
          f"sharded liar batch, multi-start, fmin_device(mesh=) and the "
          f"global mesh, each equal to the local kernel's")
    print(f"contract: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}; {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()

def net_counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


def host_ms(fn, n=NET_TIMED):
    """Host ms of each of ``n`` calls ``fn(i)``, as a list (the caller
    interleaves the turns of what it compares and takes the median)."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_netstore(dev):
    """The network store at full width, checks (a) to (f).  Returns
    ``{lowering: (eager launches, 0, 0)}`` over the server-side suggests
    and the driven run."""
    import torch.distributed as dist

    import chip_smoke
    from hyperopt_tpu_torch import backends, dispatch, wire
    from hyperopt_tpu_torch.backends import contract
    from hyperopt_tpu_torch.obs import export
    from hyperopt_tpu_torch.parallel import (FileTrials, NetTrials,
                                             StoreServer, multihost)
    from hyperopt_tpu_torch.parallel.netstore import server_suggest

    t_phase = time.perf_counter()
    metrics.set_enabled(True)
    space = flagship_space()
    cs = compile_space(space)
    ek = "flagship"
    history0 = [dict(d, exp_key=ek)
                for d in synthetic_trials(cs, N_HISTORY, 12, dev)]
    tally = Tally()
    root = tempfile.mkdtemp(prefix="chip_smoke_netstore_")
    srv = StoreServer(root, token=NET_TOKEN)
    srv.start()
    for name, kw in NET_EXTRA_HEADS.items():
        backends.register_backend(name, partial(tpe.suggest, **kw),
                                  replace=True)
    prev_mode = wire.mode()
    try:
        # (a) set-up: the flagship domain published on CUDA, the history
        # inserted and read back in binary frames.
        wire.set_mode("binary")
        f0, b0 = net_counter("wire.frames"), net_counter("wire.bytes_tx")
        nt = NetTrials(srv.url, exp_key=ek, token=NET_TOKEN)
        domain = base.Domain(objective, space)
        domain.cs.device = dev
        nt.save_domain(domain)
        t0 = time.perf_counter()
        nt.insert_trial_docs(history0)
        nt.refresh()
        ins_s = time.perf_counter() - t0
        frames = net_counter("wire.frames") - f0
        nbytes = net_counter("wire.bytes_tx") - b0
        if len(nt) != N_HISTORY or frames <= 0 or nbytes <= 0:
            fail(f"netstore (a): {len(nt)} docs read back, {frames} frames, "
                 f"{nbytes} bytes")
        local = base.trials_from_docs(copy.deepcopy(history0), exp_key=ek)
        ids = [N_HISTORY]
        print(f"netstore (a): StoreServer on {srv.url} (token), the "
              f"flagship domain published on {dev}, {N_HISTORY} docs "
              f"inserted and read back in {frames:.0f} binary frames "
              f"({nbytes:.0f} bytes sent, both directions in this process) "
              f"in {ins_s:.2f} s")

        # (b) 16 server-side TPE proposals against 16 in-process ones.
        def server_rows(mode):
            wire.set_mode(mode)
            return tally.counted("f32", lambda: [
                server_suggest(ids, None, nt, s, n_EI_candidates=N_CAND)
                for s in range(NET_SUGGESTS)])

        got = server_rows("binary")
        check_hosted("netstore (b) server-side", "f32", NET_SUGGESTS,
                     tally.graphs)
        k_bin, g_bin = dict(ei_mod.ei_scores.launches_by), tally.graphs
        want = [tpe.suggest(ids, domain, local, s, n_EI_candidates=N_CAND)
                for s in range(NET_SUGGESTS)]
        if got != want:
            bad = [s for s, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"netstore (b): server-side rows differ from the "
                 f"in-process rows at seeds {bad}")
        got_json = server_rows("json")
        if got_json != got:
            fail("netstore (b): json mode gave other docs than binary")
        print(f"netstore (b): {NET_SUGGESTS} server_suggest proposals "
              f"(seeds 0-{NET_SUGGESTS - 1}, {N_CAND} candidates) equal "
              f"the in-process tpe.suggest rows bit for bit, K1 "
              f"{k_bin['f32']} launches and {g_bin['replays']} replays of "
              f"the hosted step graph on the server side; json mode gives "
              f"the same docs")

        # (c) every head by name over the wire, against its in-process
        # call; K2 and K3 through the heads registered for them.
        table = contract.server_table()
        wire.set_mode("binary")
        heads = {}
        for name in backends.names():
            low = {"tpe_bf16": "bf16", "tpe_mxu": "mxu"}.get(name, "f32")
            n_want = int(name in TPE_FAMILY or name == "atpe"
                         or name in NET_EXTRA_HEADS)
            got1 = tally.counted(low, lambda: server_suggest(
                ids, None, nt, NET_HEAD_SEED, algo=name))
            check_hosted(f"netstore (c) {name}", low, n_want, tally.graphs)
            heads[name] = (ei_mod.ei_scores.launches_by[low],
                           tally.graphs["replays"])
            want1 = table[name](ids, domain, local, NET_HEAD_SEED)
            if got1 != want1:
                fail(f"netstore (c): {name} served over the wire differs "
                     f"from its in-process call")
        print(f"netstore (c): {len(heads)} heads served by name equal their "
              f"in-process calls (gp card against card); EI launches "
              f"and hosted graph replays through the wire {heads}")

        # (d) host ms: a server-side round trip against the in-process
        # suggest, and a full refresh in binary frames against JSON.
        # The round trip splits into the server's verb (``_dispatch``,
        # timed in its handler thread) and, inside it, the head's call.
        ms = {"server": [], "local": [], "binary": [], "json": [],
              "verb": [], "head": [], "store_refresh": []}
        heads_table = srv._server_algos()
        real_dispatch, real_head = srv._dispatch, heads_table["tpe"]

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    ms[key].append((time.perf_counter() - t0) * 1e3)
            return run

        store = srv._trials[(None, ek)]
        for turn in range(2):
            srv._dispatch = timed("verb", real_dispatch)
            heads_table["tpe"] = timed("head", real_head)
            try:
                ms["server"] += tally.counted("f32", lambda: host_ms(
                    lambda i: server_suggest(ids, None, nt, 100 + i,
                                             n_EI_candidates=N_CAND)))
            finally:
                srv._dispatch = real_dispatch
                heads_table["tpe"] = real_head
            ms["local"] += host_ms(lambda i: tpe.suggest(
                ids, domain, local, 100 + i, n_EI_candidates=N_CAND))
            ms["store_refresh"] += host_ms(lambda i: store.refresh())
            for mode in ("binary", "json"):
                wire.set_mode(mode)
                ms[mode] += host_ms(lambda i: nt.refresh())
        med = {k: float(np.median(v)) for k, v in ms.items()}
        if len(nt) != N_HISTORY or len(ms["verb"]) != 2 * NET_TIMED:
            fail(f"netstore (d): refresh read {len(nt)} docs, "
                 f"{len(ms['verb'])} timed verbs")
        print(f"netstore (d): host ms, medians of {NET_TIMED} x 2 turns: "
              f"server-side suggest round trip={med['server']:.3f} (the "
              f"server's verb {med['verb']:.3f}, the head inside it "
              f"{med['head']:.3f}) in-process suggest={med['local']:.3f} "
              f"(wire and lock {med['server'] - med['local']:+.3f}); the "
              f"server store's refresh={med['store_refresh']:.3f}; refresh "
              f"of {N_HISTORY} docs binary={med['binary']:.3f} "
              f"json={med['json']:.3f}")
        print("netstore (d) json: " + json.dumps(
            {"server_suggest_ms": med["server"],
             "server_verb_ms": med["verb"], "server_head_ms": med["head"],
             "inprocess_suggest_ms": med["local"],
             "server_store_refresh_ms": med["store_refresh"],
             "refresh_binary_ms": med["binary"],
             "refresh_json_ms": med["json"], "n_docs": N_HISTORY,
             "n_timed": NET_TIMED, "turns": 2}))

        # (e) run_driver over the server's URL, two worker processes of
        # the netstore's CLI (the hyperopt-tpu-torch-netstore entry).
        wire.set_mode("auto")
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        workers = [subprocess.Popen(
            [sys.executable, "-m", "hyperopt_tpu_torch.parallel.netstore",
             "--worker", srv.url, "--exp-key", "mh", "--token", NET_TOKEN,
             "--reserve-timeout", "5", "--poll-interval", "0.01"],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for _ in range(NET_WORKERS)]
        n_drive = tpe._default_n_startup_jobs + NET_DRIVER
        try:
            t0 = time.perf_counter()
            tally.counted("f32", lambda: multihost.run_driver(
                chip_smoke.objective, space, store_root=srv.url,
                exp_key="mh", max_evals=n_drive, token=NET_TOKEN,
                n_EI_candidates=N_CAND, rstate=np.random.default_rng(5),
                show_progressbar=False, device=dev))
            drive_s = time.perf_counter() - t0
            got_drive = (dict(ei_mod.ei_scores.launches_by),
                         dict(ei_mod.ei_scores.recorded_by))
            g_drive = tally.graphs
        finally:
            outs = []
            for p in workers:
                try:
                    outs.append(p.communicate(timeout=120))
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate())
            if dist.is_initialized():
                dispatch.clear_default_mesh()
                dist.destroy_process_group()
        for p, (_, err) in zip(workers, outs):
            if p.returncode != 0:
                fail(f"netstore (e): a worker exited {p.returncode}:\n"
                     f"{err[-2000:]}")
        ft = FileTrials(root, exp_key="mh")
        tids = [d["tid"] for d in ft]
        owners = {d["owner"] for d in ft}
        for d in ft:
            with open(ft._claim_path(d["tid"])) as f:
                if f.read() != d["owner"]:
                    fail(f"netstore (e): trial {d['tid']} claimed twice")
        if len(ft) != n_drive or len(set(tids)) != n_drive or any(
                d["state"] != base.JOB_STATE_DONE for d in ft):
            fail(f"netstore (e): {len(ft)} trials, {len(set(tids))} tids, "
                 f"states {sorted({d['state'] for d in ft})}")
        eager = check_hosted("netstore (e)", "f32", NET_DRIVER, g_drive,
                             got_drive)
        print(f"netstore (e): run_driver over {srv.url} with {NET_WORKERS} "
              f"worker processes (python -m "
              f"hyperopt_tpu_torch.parallel.netstore --worker): {n_drive} "
              f"trials DONE ({NET_DRIVER} after startup, K1 once each on "
              f"the card: {eager} eager, {g_drive['replays']} replays of "
              f"the hosted step graph), {len(owners)} owners, no tid "
              f"claimed twice, every worker exited 0, {drive_s:.1f} s")

        # (f) GET /metrics as OpenMetrics, through the strict parser.
        from urllib.request import Request, urlopen

        req = Request(srv.url + "/metrics", headers={
            "X-Netstore-Token": NET_TOKEN,
            "Accept": "application/openmetrics-text"})
        with urlopen(req, timeout=30) as resp:
            ctype = resp.headers["Content-Type"]
            text = resp.read().decode("utf-8")
        fams = export.parse_openmetrics(text)
        if ctype != export.CONTENT_TYPE or not any(
                "netstore_verb_suggest" in f for f in fams):
            fail(f"netstore (f): /metrics gave {ctype}, families "
                 f"{sorted(fams)[:20]}")
        print(f"netstore (f): GET /metrics negotiated OpenMetrics: "
              f"{len(fams)} families, {len(text)} bytes, parsed")
    finally:
        wire.set_mode(prev_mode)
        srv.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    print(f"netstore: EI wrapper over the phase's counted runs: eager "
          f"launches {tally.launches}; {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


def phase_service(dev, show=None):
    """The service tier at full width, checks (a) to (e).  Returns
    ``{lowering: (eager launches, 0, 0)}`` over the phase's server-side
    suggests, cohort windows and routed suggests.  With ``show`` (a
    :class:`ShowSteps`), its steps (b) to (e) run on the phase's server,
    WAL and router where they stand, the phase's requests to the server
    are counted by the verbs the WAL logs, and the event log records the
    served run from (c) on."""
    from hyperopt_tpu_torch import backends, wire
    from hyperopt_tpu_torch.backends import contract
    from hyperopt_tpu_torch.parallel import NetTrials, RouterTrials
    from hyperopt_tpu_torch.service import (ServiceServer, ShardServer,
                                            Tenant, TenantTable)
    from hyperopt_tpu_torch.service import wal as wal_mod
    from hyperopt_tpu_torch.service.cluster import HashRing
    from hyperopt_tpu_torch.service.router import Router
    from hyperopt_tpu_torch.service.server import ServiceServer as _Srv

    t_phase = time.perf_counter()
    metrics.set_enabled(True)
    space = flagship_space()
    cs = compile_space(space)
    ek = "flagship"
    tally = Tally()
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    wal_dir = os.path.join(root, "wal")
    table = TenantTable([Tenant(f"tenant{i}", f"{NET_TOKEN}-{i}")
                         for i in range(SVC_TENANTS)])
    mk = partial(ServiceServer, wal_dir, tenants=table, fsync="always",
                 cohort_window_ms=SVC_WINDOW_MS)
    for name, kw in NET_EXTRA_HEADS.items():
        backends.register_backend(name, partial(tpe.suggest, **kw),
                                  replace=True)
    prev_mode = wire.mode()
    servers = []
    ids = [N_HISTORY]
    kw = dict(n_EI_candidates=N_CAND)
    logged = None
    try:
        # (a) set-up: 8 tenants, each its flagship domain on the card and
        # its own seeded 1,000-trial history, in binary frames.
        wire.set_mode("binary")
        srv = mk()
        srv.start()
        servers.append(srv)
        if show is not None:
            logged = _LoggedCount(srv.url, _Srv._WAL_VERBS)
        t0 = time.perf_counter()
        tenants = []
        for i in range(SVC_TENANTS):
            nt = NetTrials(srv.url, exp_key=ek, token=f"{NET_TOKEN}-{i}",
                           timeout=120.0)
            domain = base.Domain(objective, space)
            domain.cs.device = dev
            nt.save_domain(domain)
            docs = [dict(d, exp_key=ek)
                    for d in synthetic_trials(cs, N_HISTORY, 40 + i, dev)]
            nt.insert_trial_docs(docs)
            local = base.trials_from_docs(copy.deepcopy(docs), exp_key=ek)
            tenants.append((nt, domain, local))
        set_s = time.perf_counter() - t0
        n_stores = len(srv._trials)
        if n_stores != SVC_TENANTS or any(
                len(st._by_tid) != N_HISTORY for st in srv._trials.values()):
            fail(f"service (a): {n_stores} stores, sizes "
                 f"{[len(st._by_tid) for st in srv._trials.values()]}")
        print(f"service (a): ServiceServer on {srv.url} (tenant table of "
              f"{SVC_TENANTS}, fsync=always, WAL in {wal_dir}, cohort "
              f"window {SVC_WINDOW_MS:.0f} ms): {SVC_TENANTS} tenants "
              f"published the flagship domain on {dev} and inserted "
              f"{N_HISTORY} docs each in binary frames in {set_s:.2f} s")

        # (b) the RAM store's round trip: a server-side suggest against
        # the in-process one on the same history, medians of 10 in two
        # turns, the gate detached so that no window is waited out.
        nt, domain, local = tenants[0]
        store = srv._trials[("tenant0", ek)]
        scs = srv._domain_for(store).cs
        ms = {"server": [], "local": [], "verb": [], "history": []}
        real_dispatch = srv._dispatch

        def timed_verb(*a, **k):
            t1 = time.perf_counter()
            try:
                return real_dispatch(*a, **k)
            finally:
                ms["verb"].append((time.perf_counter() - t1) * 1e3)

        gate, srv._cohort_gate = srv._cohort_gate, None
        got, want = [], []
        try:
            for turn in range(2):
                seeds = [SVC_SEED + 10 * turn + i for i in range(NET_TIMED)]
                srv._dispatch = timed_verb
                try:
                    ms["server"] += tally.counted("f32", lambda: host_ms(
                        lambda i: got.append(nt.suggest(
                            seeds[i], new_ids=ids, insert=False, **kw))))
                finally:
                    srv._dispatch = real_dispatch
                check_hosted(f"service (b) turn {turn}", "f32", NET_TIMED,
                             tally.graphs)
                ms["local"] += host_ms(lambda i: want.append(tpe.suggest(
                    ids, domain, local, seeds[i], **kw)))
                ms["history"] += host_ms(lambda i: store.history(scs))
        finally:
            srv._cohort_gate = gate
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"service (b): server-side rows differ from the "
                 f"in-process rows at calls {bad}")
        med = {k: float(np.median(v)) for k, v in ms.items()}
        print(f"service (b): host ms, medians of {NET_TIMED} x 2 turns: "
              f"server-side suggest round trip on the RAM store="
              f"{med['server']:.3f} (the server's verb {med['verb']:.3f}) "
              f"in-process suggest={med['local']:.3f} (wire and lock "
              f"{med['server'] - med['local']:+.3f}); the store's columnar "
              f"history={med['history']:.3f}; {2 * NET_TIMED} rows equal "
              f"bit for bit, K1 once each, launched or replayed (the file "
              f"store of the netstore phase: 86.7-117.9 against 13.4-18.9 "
              f"ms)")
        print("service (b) json: " + json.dumps(
            {"server_suggest_ms": med["server"],
             "server_verb_ms": med["verb"],
             "inprocess_suggest_ms": med["local"],
             "store_history_ms": med["history"], "n_docs": N_HISTORY,
             "n_timed": NET_TIMED, "turns": 2}))

        # (c) the cohort gate: the 8 tenants suggest concurrently, three
        # windows in a row; then a window where a 9th request carries
        # gamma= and must take the solo path.
        solo = [[tpe.suggest([N_HISTORY + w], t[1], t[2],
                             SVC_SEED + 100 * w + i, **kw)
                 for i, t in enumerate(tenants)]
                for w in range(SVC_WINDOWS + 1)]

        def window(w, extra=None):
            out = [None] * (SVC_TENANTS + (extra is not None))

            def call(i):
                if i == SVC_TENANTS:
                    out[i] = extra()
                    return
                out[i] = tenants[i][0].suggest(
                    SVC_SEED + 100 * w + i, new_ids=[N_HISTORY + w],
                    insert=False, **kw)

            ths = [threading.Thread(target=call, args=(i,))
                   for i in range(len(out))]
            t1 = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            if any(th.is_alive() for th in ths):
                fail(f"service (c): window {w} hung")
            return out, (time.perf_counter() - t1) * 1e3

        if show is not None:
            EVENTS.clear()
            EVENTS.enable()
        d0 = fleet.dispatches
        win_ms = []
        for w in range(SVC_WINDOWS):
            rows, wms = tally.counted("f32", lambda: window(w))
            win_ms.append(wms)
            # One cohort dispatch, one K1 launch, no hosted step.
            check_hosted(f"service (c): window {w}", "f32", 1, tally.graphs)
            if rows != solo[w]:
                bad = [i for i, (a, b) in enumerate(zip(rows, solo[w]))
                       if a != b]
                fail(f"service (c): window {w}: tenants {bad}'s rows differ "
                     f"from their solo rows")
        n_disp = fleet.dispatches - d0
        tier = fleet.cohort_tier_last
        if n_disp != SVC_WINDOWS:
            fail(f"service (c): {n_disp} fleet dispatches for "
                 f"{SVC_WINDOWS} windows")
        # the gamma request: a second store of tenant 0 with the same
        # history, in the same window as the 8 tenants.
        gt = NetTrials(srv.url, exp_key=ek + "-gamma",
                       token=f"{NET_TOKEN}-0", timeout=120.0)
        gt.save_domain(tenants[0][1])
        gdocs = [dict(d, exp_key=ek + "-gamma") for d in tenants[0][2]]
        gt.insert_trial_docs(copy.deepcopy(gdocs))
        glocal = base.trials_from_docs(copy.deepcopy(gdocs),
                                       exp_key=ek + "-gamma")
        w = SVC_WINDOWS
        gwant = tpe.suggest([N_HISTORY + w], tenants[0][1], glocal, 77,
                            gamma=0.5, **kw)
        d1 = fleet.dispatches
        rows, _ = tally.counted("f32", lambda: window(w, lambda: gt.suggest(
            77, new_ids=[N_HISTORY + w], insert=False, gamma=0.5, **kw)))
        # The cohort's launch and the solo step's K1, launched or replayed.
        check_hosted("service (c): the gamma window", "f32", 2, tally.graphs)
        if rows[:SVC_TENANTS] != solo[w] or rows[SVC_TENANTS] != gwant:
            fail("service (c): the gamma window's rows differ from the "
                 "solo rows")
        if fleet.dispatches - d1 != 1:
            fail(f"service (c): the gamma window: "
                 f"{fleet.dispatches - d1} dispatches")
        print(f"service (c): {SVC_WINDOWS} windows of {SVC_TENANTS} "
              f"concurrent tenants: each tenant's rows equal its solo "
              f"in-process rows bit for bit; fleet.dispatches +{n_disp}, "
              f"K1 once per window over 31x{tier} columns (lane tier "
              f"{tier}); ms per window (wall, window included) "
              f"{[round(x, 3) for x in win_ms]}; a 9th request with "
              f"gamma=0.5 in a 4th window took the solo path (1 dispatch, "
              f"2 K1 runs), its row equal to the in-process one")
        if show is not None:
            show.live(srv.url, f"{NET_TOKEN}-0", "service",
                      tenants=[f"tenant{i}" for i in range(SVC_TENANTS)],
                      cohort=(SVC_TENANTS, tier))
            show.pull_bundle(tenants[0][0], "service")

        # (d) crash and recovery: the server stops without a snapshot; a
        # new one on the same WAL directory rebuilds the same bytes and
        # launches no kernel.  Then K2 and K3 served by name.
        live = srv.state_bytes()
        srv.shutdown()
        servers.remove(srv)
        info = wal_mod.inspect(wal_dir)
        if show is not None:
            logged.stop()
            show.wal(wal_dir, logged.counts)
        d2 = fleet.dispatches
        t1 = time.perf_counter()
        srv = tally.counted("f32", mk)
        rec_s = time.perf_counter() - t1
        servers.append(srv)
        k_d = dict(ei_mod.ei_scores.launches_by)
        if srv.state_bytes() != live:
            fail("service (d): the recovered state_bytes() differ")
        if sum(k_d.values()) or fleet.dispatches != d2:
            fail(f"service (d): recovery launched {k_d}, dispatched "
                 f"{fleet.dispatches - d2}")
        srv.start()
        nt = NetTrials(srv.url, exp_key=ek, token=f"{NET_TOKEN}-0",
                       timeout=120.0)
        table_ = contract.server_table()
        by_name = {}
        for name in NET_EXTRA_HEADS:
            low = {"tpe_bf16": "bf16", "tpe_mxu": "mxu"}[name]
            got1 = tally.counted(low, lambda: nt.suggest(
                NET_HEAD_SEED, new_ids=ids, insert=False, algo=name, **kw))
            check_hosted(f"service (d) {name}", low, 1, tally.graphs)
            by_name[name] = (ei_mod.ei_scores.launches_by[low],
                             tally.graphs["replays"])
            want1 = table_[name](ids, tenants[0][1], tenants[0][2],
                                 NET_HEAD_SEED, **kw)
            if got1 != want1:
                fail(f"service (d): {name}: rows differ from the "
                     f"in-process ones")
        print(f"service (d): stopped without a snapshot "
              f"({info['records']} WAL records, {info['wal_bytes']} bytes); "
              f"a new ServiceServer on the WAL recovered the same "
              f"state_bytes() ({len(live)} bytes) in {rec_s:.2f} s with no "
              f"EI launch and no dispatch; tpe_bf16 and tpe_mxu served by "
              f"name after it (launches, hosted graph replays): {by_name}, "
              f"rows equal the in-process ones")
        if show is not None:
            show.pull_bundle(nt, "recovered")
            show.merge()
            show.bundle()
        srv.shutdown()
        servers.remove(srv)

        # (e) the fleet: a Router over 2 ShardServer primaries with a
        # replica each; routed suggests, shard_add with a moved store,
        # and a primary shut down under the router.
        ring2, ring3 = HashRing(["s0", "s1"]), HashRing(["s0", "s1", "s2"])
        keys = [f"fleet{i}" for i in range(200)]
        k0 = next(k for k in keys if ring2.owner(None, k) == "s0"
                  and ring3.owner(None, k) == "s0")
        k1 = next(k for k in keys if ring2.owner(None, k) == "s1"
                  and ring3.owner(None, k) == "s2")
        shard = partial(ShardServer, token=NET_TOKEN, fsync="always")
        entries = {}
        prims = {}
        for sid in ("s0", "s1"):
            rep = shard(os.path.join(root, sid + "r"), role="replica")
            rep.start()
            prim = shard(os.path.join(root, sid + "p"), role="primary")
            prim.start()
            prim.attach_replica(rep.url)
            servers += [rep, prim]
            prims[sid] = prim
            entries[sid] = {"primary": prim.url, "replica": rep.url}
        router = Router(entries, token=NET_TOKEN, retries=1, backoff=0.01)
        router.start()
        fleet_ok = []
        try:
            routed = {}
            for j, k in enumerate((k0, k1)):
                rt = RouterTrials(router.url, exp_key=k, token=NET_TOKEN,
                                  timeout=120.0, map_refresh_s=0.0)
                dom = base.Domain(objective, space)
                dom.cs.device = dev
                rt.save_domain(dom)
                docs = [dict(d, exp_key=k)
                        for d in synthetic_trials(cs, N_HISTORY, 60 + j,
                                                  dev)]
                rt.insert_trial_docs(docs)
                loc = base.trials_from_docs(copy.deepcopy(docs), exp_key=k)
                routed[k] = (rt, dom, loc)

            def routed_equal(k, seed, what):
                rt, dom, loc = routed[k]
                got1 = tally.counted("f32", lambda: rt.suggest(
                    seed, new_ids=ids, insert=False, **kw))
                check_hosted(f"service (e) {what}", "f32", 1, tally.graphs)
                if got1 != tpe.suggest(ids, dom, loc, seed, **kw):
                    fail(f"service (e): {what}: routed rows of {k} differ")
                fleet_ok.append(what)
                return rt.shard_id

            owners = [routed_equal(k, 5, "routed") for k in (k0, k1)]
            if owners != ["s0", "s1"]:
                fail(f"service (e): owners {owners}")
            if show is not None:
                show.live(router.url, NET_TOKEN, "router", shards=2)
            before = prims["s1"]._trials[(None, k1)].state_bytes()
            new = shard(os.path.join(root, "s2p"), role="primary")
            new.start()
            servers.append(new)
            t1 = time.perf_counter()
            out = router._shard_add_verb({"shard": "s2", "url": new.url})
            add_s = time.perf_counter() - t1
            moved = new._trials.get((None, k1))
            if (out["migrated"] < 1 or moved is None
                    or moved.state_bytes() != before):
                fail(f"service (e): shard_add {out}; moved store "
                     f"{'missing' if moved is None else 'differs'}")
            if routed_equal(k1, 6, "moved") != "s2":
                fail("service (e): the moved store's client did not "
                     "re-place onto s2")
            for sh in prims["s0"]._shippers:
                if not sh.flush(timeout=60.0):
                    fail("service (e): s0's replica never caught up")
            prims["s0"].shutdown()
            f0 = net_counter("router.failovers")
            routed_equal(k0, 7, "failover")
            rt = routed[k0][0]
            rt.refresh()
            if (net_counter("router.failovers") != f0 + 1
                    or rt._rpc.url != entries["s0"]["replica"]
                    or sorted(d["tid"] for d in rt) != list(
                        range(N_HISTORY))):
                fail(f"service (e): failover: {net_counter('router.failovers') - f0} "
                     f"promotions, client on {rt._rpc.url}, {len(rt)} docs")
            print(f"service (e): Router over 2 ShardServer primaries with "
                  f"a replica each: routed suggests of {k0} (s0) and {k1} "
                  f"(s1) equal the in-process rows; shard_add s2 migrated "
                  f"{out['migrated']} store(s) in {add_s:.2f} s, {k1}'s "
                  f"state_bytes() unchanged on s2 and its next suggest "
                  f"equal; s0's primary shut down, the router promoted its "
                  f"replica and the next suggest of {k0} is equal, "
                  f"{N_HISTORY} trials kept ({len(fleet_ok)} routed "
                  f"suggests, K1 once each, launched or replayed)")
        finally:
            router.shutdown()
    finally:
        if logged is not None:
            logged.stop()
        if show is not None:
            EVENTS.disable()
            EVENTS.clear()
        wire.set_mode(prev_mode)
        for s_ in servers:
            s_.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    print(f"service: EI wrapper over the phase's counted runs: eager "
          f"launches {tally.launches}; {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


class _LoggedCount:
    """Counts this process's requests to one server by the WAL records
    they make (``ServiceServer._suggest_walled``'s decomposition: a
    suggest logs ``new_trial_ids`` when the server picks the ids and
    ``insert_docs`` when it inserts; every other verb of the catalog logs
    itself), by wrapping the client's ``_Rpc.__call__``."""

    def __init__(self, url, verbs):
        from hyperopt_tpu_torch.parallel import netstore
        self.counts = {}
        self._cls = netstore._Rpc
        self._real = real = netstore._Rpc.__call__
        url = url.rstrip("/")

        def call(rpc, verb, **kw):
            out = real(rpc, verb, **kw)
            if rpc.url == url and verb in verbs:
                if verb != "suggest":
                    logs = [verb]
                else:
                    picks = "new_ids" not in kw
                    logs = (["new_trial_ids"] if picks else []) + (
                        ["insert_docs"] if kw.get("insert", picks) else [])
                for v in logs:
                    self.counts[v] = self.counts.get(v, 0) + 1
            return out

        netstore._Rpc.__call__ = call

    def stop(self):
        self._cls.__call__ = self._real


class ShowSteps:
    """The show phase: the port's ``hyperopt-tpu-torch-show`` verbs on
    the artifacts of the phases before it, each step called where they
    stand (:func:`phase_obs` (c), :func:`phase_service`) and timed; the
    lint step and the summary run in :func:`phase_show`."""

    def __init__(self, card):
        self.card = card
        self.root = tempfile.mkdtemp(prefix="chip_smoke_show_")
        self.steps = {}
        self.bundles = []
        self.trace_copy = None
        self.wal_info = None
        self.lint = None

    def _timed(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        self.steps[name] = time.perf_counter() - t0
        return out

    def trace(self, trace_dir, trials):
        """(a) ``show trace`` and ``--pickle`` of the run's trials."""
        from hyperopt_tpu_torch import show

        def summary():
            buf = io.StringIO()
            show.summarize_trace(trace_dir, out=buf)
            return buf.getvalue()

        text = self._timed("a trace", summary)
        cov = re.search(r"\(([0-9.]+)% coverage\)", text)
        if cov is None or float(cov.group(1)) < 95.0:
            fail(f"show (a): the phases cover {cov and cov.group(1)}% of "
                 f"wall, wanted >= 95%:\n{text}")
        rows = {ln.split()[0] for ln in text.splitlines()[1:] if ln.strip()}
        if not {"suggest", "evaluate"} <= rows:
            fail(f"show (a): no suggest/evaluate rows:\n{text}")
        with open(os.path.join(trace_dir, obs_trace.PROFILER_TRACE)) as fh:
            names = [e.get("name", "") for e in json.load(fh)["traceEvents"]
                     if e.get("cat") == "kernel"]
        n_k1 = sum(KERNEL_SYMBOLS["f32"] in n for n in names)
        if not n_k1:
            fail("show (a): profiler_trace.json names no K1 launch")
        self.trace_copy = os.path.join(self.root, "obs_trace")
        shutil.copytree(trace_dir, self.trace_copy)
        # The run's trials, pickled: no object of torch's in the stream
        # (no tensor, so no CUDA storage), and ``--pickle`` summarizes it.
        path = os.path.join(self.root, "trials.pkl")
        with open(path, "wb") as fh:
            pickle.dump(trials, fh)
        with open(path, "rb") as fh:
            blob = fh.read()
        refs = sorted({arg for op, arg, _ in pickletools.genops(blob)
                       if isinstance(arg, str)
                       and (arg == "torch" or arg.startswith("torch."))})
        if refs:
            fail(f"show (a): the pickled trials name {refs}")
        want = io.StringIO()
        show.summarize(trials, out=want)
        got = io.StringIO()
        with contextlib.redirect_stdout(got):
            rc = self._timed("a pickle", lambda: show.main(
                ["--pickle", path]))
        if rc != 0 or got.getvalue() != want.getvalue():
            fail(f"show (a): --pickle exited {rc}:\n{got.getvalue()}")
        print(f"show (a): show trace over obs (c)'s fmin(trace_dir=) "
              f"({len(trials)} trials): coverage {cov.group(1)}%, "
              f"profiler_trace.json names {KERNEL_SYMBOLS['f32']} {n_k1} "
              f"times; {len(blob)} bytes of pickled trials (no torch "
              f"object in the stream) summarized by --pickle in "
              f"{self.steps['a pickle']:.3f} s; show trace "
              f"{self.steps['a trace']:.3f} s ({self.card})")
        print(text.rstrip())

    def live(self, url, token, what, tenants=(), cohort=None, shards=None):
        """(c) ``show live --once`` against a running server or router."""
        from hyperopt_tpu_torch import show

        buf = io.StringIO()
        rc = self._timed(f"c live {what}", lambda: show.live(
            url, token=token, once=True, out=buf))
        text = buf.getvalue()
        rows = {ln.split()[0] for ln in text.splitlines() if ln.strip()}
        missing = [t for t in tenants if t not in rows]
        bad = rc != 0 or missing
        if cohort is not None and \
                f"cohorts: last {cohort[0]}/{cohort[1]} lanes" not in text:
            bad = True
        if shards is not None and (
                f"router: {shards} shard(s)" not in text
                or sum(f"s{i}" in rows for i in range(shards)) != shards
                or "DOWN" in text):
            bad = True
        if bad:
            fail(f"show (c): live against the {what} (rc {rc}, tenants "
                 f"missing {missing}):\n{text}")
        print(f"show (c): show live --once against the {what} on {url}: "
              f"{len(tenants)} tenant rows, "
              + (f"cohorts line 'last {cohort[0]}/{cohort[1]} lanes', "
                 if cohort else "")
              + (f"{shards} shards ok, " if shards else "")
              + f"{self.steps[f'c live {what}']:.3f} s ({self.card})")
        print(text.rstrip())

    def pull_bundle(self, client, what):
        out = os.path.join(self.root, f"bundle-{what}")
        payload = client.bundle(out_dir=out)
        if not payload.get("events"):
            fail(f"show: the {what} server's bundle holds no events")
        self.bundles.append(out)

    def wal(self, wal_dir, counts):
        """(d) ``show wal`` and ``--json`` over the service WAL."""
        from hyperopt_tpu_torch import show

        text, js = io.StringIO(), io.StringIO()
        rc = self._timed("d wal", lambda: show.show_wal(wal_dir, out=text))
        rc_j = self._timed("d wal --json", lambda: show.show_wal(
            wal_dir, as_json=True, out=js))
        info = json.loads(js.getvalue())
        if rc or rc_j or info["per_verb"] != counts or info["torn_tail"] \
                or info["records"] != sum(counts.values()):
            fail(f"show (d): per_verb {info['per_verb']} against the "
                 f"phase's {counts}; torn {info['torn_tail']}, records "
                 f"{info['records']}")
        self.wal_info = info
        print(f"show (d): show wal over the service WAL ({info['records']} "
              f"records, {info['wal_bytes']} bytes): per_verb equals the "
              f"phase's own count {counts}; text "
              f"{self.steps['d wal']:.3f} s, --json "
              f"{self.steps['d wal --json']:.3f} s ({self.card})")
        print(text.getvalue().rstrip())

    def merge(self):
        """(b) ``show trace --merge`` over the served run's bundles and
        the obs trace."""
        from hyperopt_tpu_torch import show

        dirs = self.bundles + [self.trace_copy]
        out = os.path.join(self.root, "merged_trace.json")
        buf = io.StringIO()
        doc = self._timed("b merge", lambda: show.merge_traces(
            dirs, out_path=out, out=buf))
        lanes = {e["pid"] for e in doc["traceEvents"]
                 if e.get("ph") != "M" and e.get("cat") != "trial_flow"}
        if doc["otherData"]["n_lanes"] != len(dirs) or \
                lanes != set(range(1, len(dirs) + 1)) or \
                "warning" in buf.getvalue():
            fail(f"show (b): merged {doc['otherData']} with events in "
                 f"lanes {sorted(lanes)}:\n{buf.getvalue()}")
        print(f"show (b): show trace --merge over {len(dirs)} dirs (the "
              f"service and recovered servers' bundles, obs (c)'s trace): "
              f"{buf.getvalue().strip().splitlines()[-1]}; "
              f"{os.path.getsize(out)} bytes, "
              f"{self.steps['b merge']:.3f} s ({self.card})")

    def bundle(self):
        """(e) ``show bundle`` on the service server's bundle."""
        from hyperopt_tpu_torch import show

        buf = io.StringIO()
        rc = self._timed("e bundle", lambda: show.show_bundle(
            self.bundles[0], out=buf))
        text = buf.getvalue()
        if rc != 0 or "events:" not in text or "ring:" not in text:
            fail(f"show (e): show bundle exited {rc}:\n{text}")
        print(f"show (e): show bundle {self.steps['e bundle']:.3f} s "
              f"({self.card})")
        print(text.rstrip())


def phase_show(show):
    """(f) ``show lint --root`` on the checkout, then every step's wall
    time and the ``show json:`` line."""
    from hyperopt_tpu_torch import show as show_mod

    root = os.path.dirname(os.path.abspath(__file__))
    want = {"a trace", "a pickle", "c live service", "c live router",
            "d wal", "d wal --json", "b merge", "e bundle"}
    try:
        if set(show.steps) != want:
            fail(f"show: steps run {sorted(show.steps)}, wanted "
                 f"{sorted(want)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = show._timed("f lint", lambda: show_mod.main(
                ["lint", "--root", root]))
        text = out.getvalue().strip()
        last = text.splitlines()[-1] if text else ""
        found = re.match(r"(\d+) finding\(s\): (\d+) new, (\d+) "
                         r"baselined, (\d+) stale", last)
        if rc != 0 or found is None or found.group(2) != "0" or \
                found.group(4) != "0":
            fail(f"show (f): show lint exited {rc}:\n{text[-3000:]}")
        show.lint = int(found.group(1))
        print(f"show (f): show lint --root {root}: {last} "
              f"({show.steps['f lint']:.3f} s; {show.card})")
        for name in sorted(show.steps):
            print(f"show {name}: {show.steps[name]:.3f} s ({show.card})")
        print("show json: " + json.dumps(
            {"card": show.card, "steps_s": show.steps,
             "wal_records": show.wal_info["records"],
             "wal_bytes": show.wal_info["wal_bytes"],
             "lint_findings": show.lint}))
    finally:
        shutil.rmtree(show.root, ignore_errors=True)


def phase_examples(card):
    """Every ``examples_torch/`` script on the card, in this process
    through ``runpy``, at its own budget: checks in the module doc.
    ``fmin`` and ``fmin_device`` are wrapped to read each run's best loss
    (and to turn the progress bar off); nothing else changes.  Returns
    ``{lowering: (eager launches, launches recorded into graphs, replays
    of graphs that hold the kernel)}`` over the scripts."""
    import importlib.util
    import runpy

    from hyperopt_tpu_torch import atpe

    root = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(root, EXAMPLES_DIR)
    scripts = sorted(f for f in os.listdir(folder) if f.endswith(".py"))
    tally = Tally()
    reg = metrics.registry()
    runs = []

    def fmin(*args, **kwargs):
        kwargs.setdefault("show_progressbar", False)
        out = real_fmin(*args, **kwargs)
        runs.append((kwargs["trials"].best_trial["result"]["loss"], None))
        return out

    def fmin_device(*args, **kwargs):
        best, info = real_device(*args, **kwargs)
        runs.append((info["best_loss"], info["n_trials"]))
        return best, info

    def n_sharded():
        return reg.snapshot()["counters"].get("dispatch.sharded", 0.0)

    tmp = tempfile.mkdtemp(prefix="chip-smoke-examples-")
    real_fmin, real_device = ho.fmin, ho.fmin_device
    saved = sys.argv, list(sys.path), atpe.set_transfer_store(None)
    ho.fmin, ho.fmin_device = fmin, fmin_device
    t_phase = time.perf_counter()
    try:
        for script in scripts:
            if script.startswith("06") and \
                    importlib.util.find_spec("sklearn") is None:
                print("examples: 06 not run: no sklearn")
                continue
            path = os.path.join(folder, script)
            sys.argv = [path]
            if script.startswith("08"):
                sys.argv += ["--transfer-store",
                             os.path.join(tmp, "atpe_transfer.json")]
            runs.clear()
            before = (dict(tally.launches), dict(tally.recorded),
                      tally.replayed["f32"], n_sharded())
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    tally.counted("f32", partial(runpy.run_path, path,
                                                 run_name="__main__"))
            except Exception as e:
                raise RuntimeError(f"examples: {script} raised:\n"
                                   f"{out.getvalue()[-3000:]}") from e
            wall = time.perf_counter() - t0
            text = out.getvalue()
            print("".join(f"  | {line}\n" for line in text.splitlines()),
                  end="")
            launched = {k: tally.launches[k] - before[0][k] for k in KERNELS}
            recorded = {k: tally.recorded[k] - before[1][k] for k in KERNELS}
            replayed = tally.replayed["f32"] - before[2]
            hosted = tally.graphs
            found = [float(m.group(1)) for m in EXAMPLE_RESULT.finditer(text)]
            losses = [loss for loss, _ in runs]
            if not found or not all(map(math.isfinite, found + losses)) \
                    or not losses:
                fail(f"examples: {script} printed no result line, or a "
                     f"best loss that is not finite ({losses}):\n{text}")
            if launched["f32"] + recorded["f32"] + replayed == 0 or any(
                    launched[k] + recorded[k] for k in ("bf16", "mxu")) \
                    or hosted["eager_steps"] \
                    or recorded["f32"] < hosted["captures"]:
                fail(f"examples: {script} launched the EI kernels "
                     f"{launched}, recorded {recorded} and replayed "
                     f"{replayed} times (hosted graphs {hosted}): K1 and "
                     f"only K1 must run, and each hosted capture record it")
            extra = ""
            if script.startswith("04"):
                sharded = n_sharded() - before[3]
                if sharded != EXAMPLE_SHARDED:
                    fail(f"examples: 04 counted {sharded} sharded "
                         f"suggests, wanted {EXAMPLE_SHARDED}")
                extra = f", dispatch.sharded +{sharded:.0f}"
            if script.startswith("11"):
                trials = sum(n for _, n in runs)
                if device.eager_steps != 0 or device.replays != trials:
                    fail(f"examples: 11 ran {device.eager_steps} eager "
                         f"steps and {device.replays} replays for "
                         f"{trials} trials")
                extra = (f", device.replays {device.replays} for {trials} "
                         f"trials, eager_steps == 0")
            print(f"examples {script}: {wall:.3f} s, best loss "
                  f"{min(losses)!r} (runs {losses}), K1 launches "
                  f"{launched['f32']} ({recorded['f32']} recorded into "
                  f"graphs, {replayed} graph replays, "
                  f"{hosted['replays']} of them the hosted step's, "
                  f"{hosted['captures']} hosted captures){extra}; {card}")
    finally:
        ho.fmin, ho.fmin_device = real_fmin, real_device
        sys.argv, sys.path[:] = saved[0], saved[1]
        atpe.set_transfer_store(saved[2])
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"examples: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}; {time.perf_counter() - t_phase:.1f} s")
    return tally.rows()


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds printed and kept."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.3f} s ({card})")
        return out

    timed("build", phase_build)
    kernels = timed("ei_kernel", phase_ei_kernel, dev)
    timed("lane_uniforms", phase_lane_uniforms, dev)
    timed("set_weights", phase_set_weights, dev)
    hosted = timed("suggest_step", phase_suggest_step, dev)
    fmin_launches = timed("fmin", phase_fmin, dev)
    liar_launches = timed("liar_batch", phase_liar_batch, dev)
    device_launches, solo_rates = timed("device_mode", phase_device_mode,
                                        dev, hosted)
    fleet_launches, fleet_times = timed("fleet", phase_fleet, dev,
                                        solo_rates)
    show = ShowSteps(card)
    obs_launches = timed("obs", phase_obs, dev, show)
    pipeline_launches = timed("pipeline", phase_pipeline, dev)
    rest_launches = timed("tpe_rest", phase_tpe_rest, dev, hosted)
    heads_launches, heads_err = timed("heads", phase_heads, dev)
    dispatch_launches = timed("dispatch", phase_dispatch, dev)
    contract_launches = timed("contract", phase_contract, dev)
    netstore_launches = timed("netstore", phase_netstore, dev)
    service_launches = timed("service", phase_service, dev, show)
    timed("show", phase_show, show)
    examples_launches = timed("examples", phase_examples, card)
    timed("card_tests", phase_card_tests)
    print("phase seconds: " + json.dumps(
        {k: round(v, 3) for k, v in seconds.items()}))
    print(f"total seconds {time.perf_counter() - t0:.1f}")
    rows = []
    for low, (name, source, replaces, _, _) in KERNELS.items():
        # Launches on the main paths, each counted from zero just before
        # its run: the fmin phase (f32), this lowering's liar_batch run,
        # device_mode's, the fleet's, obs's and tpe_rest's eager warm-up
        # steps, the cohort dispatches, obs's hosted runs, the pipeline
        # phase's runs, tpe_rest's hosted runs, the heads phase's
        # hosted runs, the dispatch phase's runs (K1 only), the
        # contract phase's entry step, capture and dry run (K1 only), the
        # netstore phase's server-side suggests and driven run, the
        # service phase's suggests, cohort windows and routed suggests,
        # and the examples phase's scripts (K1 only).
        # A capture records
        # the launch into its graph without running it (graph_recorded);
        # graph_replays counts replays of graphs that hold the kernel, one
        # kernel run each (for all lanes) by the profiler's count in
        # device_mode (c), (d), fleet (c), obs (a), tpe_rest's
        # counted runs and the contract phase's replays.  fleet_ms: the
        # kernel through its wrapper at 31·L columns.
        dev_launches, dev_recorded, dev_replays = (
            sum(parts) for parts in zip(fmin_launches[low],
                                        device_launches[low],
                                        fleet_launches[low],
                                        obs_launches[low],
                                        pipeline_launches[low],
                                        rest_launches[low],
                                        heads_launches[low],
                                        dispatch_launches[low],
                                        contract_launches[low],
                                        netstore_launches[low],
                                        service_launches[low],
                                        examples_launches[low]))
        n = liar_launches[low] + dev_launches
        k = kernels[low]
        if low == "f32":
            k["max_abs_err"] = max(k["max_abs_err"], heads_err)
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
    # Again at the end, where a reader of the output's tail finds it.
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

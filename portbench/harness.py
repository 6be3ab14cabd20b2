"""One run of one cell of ``BENCHMARK.json``.

The cell names a configuration (``configs/<config>.json``: the space, its
sizes and the TPE settings) and a traffic mix (``traffic/<traffic>.json``:
the driver, ``drivers/<driver>.py``, and its parameters).  A run sets up
the driver's state, measures one window, with ``--trace 1`` profiles a
bounded segment after it, reads the peak device memory, and then checks
what the window produced against the plain reference (``check.py``,
limits in ``checks/<workload>.json``).  Every metric of the cell is read by
its own file, ``metrics/<name>.py``, whose ``read(run)`` returns a number
or None.  The result is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import check, program, timing
from .reference import space as rspace
from .reference import tpe as rtpe
from .trace import Segment

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded when a run ends.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hyperopt_tpu"})


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file(path):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        "portbench._file_." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Cell:
    """One cell: its configuration, traffic, seed and device."""

    def __init__(self, entry, config, traffic, seed, device, limits,
                 overrides=None):
        self.name = entry["name"]
        self.entry = entry
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.seed_key = self.seed % (2 ** 63)
        self.device = torch.device(device)
        self.limits = limits
        self.builder = load_file(HERE / "spaces" / f"{config['space']}.py")
        self.n_dims = int(config["n_dims"])
        self.ps = rspace.params(self.builder.build(rspace.PLAIN_HP,
                                                   self.n_dims))
        self.labels = self.builder.objective_labels(self.n_dims)
        self.tpe = dict(config["tpe"], **(overrides or {}))
        self.settings = rtpe.Settings(config["tpe"],
                                      config["n_EI_candidates"])

    def program_tpe(self):
        """The keywords of the program's TPE entry points."""
        return dict(self.tpe, n_EI_candidates=int(
            self.config["n_EI_candidates"]))


def load_cell(bench, workload, seed, device, overrides=None):
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "checks" / f"{workload}.json")["limits"]
    return Cell(entry, config, traffic, seed, device, limits, overrides)


def cell_metrics(bench, cell_name, kind):
    """The entries of ``bench[kind]`` this cell reports: those that list it
    under ``workloads``; one without the key, in every cell (end-to-end),
    or in every cell that reports the metric it ``moves`` (per-layer)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def require_devices(chips):
    """Exit without a result unless ``chips`` cards are visible."""
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available"
                         "() is false); no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible; "
                         f"no result")


class Run:
    """What the metric readers see: the cell, ``setup_s``, the measured
    ``window`` (``window.Window``) and, with ``--trace 1``, ``traced``
    (``window.Traced``)."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.window = None
        self.traced = None


def execute(bench, cell, seconds, traced, driver=None):
    """Run ``cell``; returns ``(result, lines)``: the result's dict and the
    lines of readings against limits."""
    driver = driver or importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    dev = cell.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell)
    state = driver.setup(cell)
    if cuda:
        torch.cuda.synchronize(dev)
    # What set-up left behind is collected now and kept out of the window's
    # collections, so that they scan only what the window allocates.
    gc.collect()
    gc.freeze()
    run.setup_s = timing.since_process_start()
    before = program.counters()
    run.window = driver.window(state, seconds, cell.seed_key)
    after = program.counters()
    run.window.counters = {k: after[k] - before[k] for k in after}
    if traced:
        run.traced = driver.profile(state, Segment(dev))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    try:
        readings = driver.check_window(
            state, run.window, np.random.default_rng([cell.seed_key, 7]))
    finally:
        driver.close(state)
    correct, checks = check.verdict(readings, cell.limits)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell.name, kind):
        v = load_file(HERE / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": int(cell.entry.get("chips", 1)),
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.window.attempted,
              "failed": run.window.failed, "metrics": metrics,
              "device": device}
    if traced:
        red = run.traced.reduced
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    return result, lines


def card_report():
    """The card's name, power limit and SM clock, from ``nvidia-smi``."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi: {e}"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload, args.seed, "cuda:0")
    require_devices(int(cell.entry["chips"]))
    result, lines = execute(bench, cell, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}; no result", file=sys.stderr)
        return 1
    if args.trace:
        print(f"card: {card_report()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0

"""Readings that the limits in ``checks/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--seconds 4] [--control bf16]

In one process: the cell's set-up once (from the first seed), then for
each seed a short window at the cell's own load and the check of what it
produced; one JSON line of readings per seed.  ``--control bf16`` runs the
program with its own lower-precision EI lowering (``ei_precision="bf16"``,
the kernel K2), the control that the limits must fail.  The benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "portbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                  "triton")
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402


def readings(workload, seeds, seconds, control=None, device="cuda:0",
             tweak=None):
    """Yield ``(seed, readings)`` for each seed of ``seeds``."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    overrides = {"ei_precision": control} if control else None
    cell = harness.load_cell(bench, workload, seeds[0], device, overrides)
    if tweak is not None:
        tweak(cell)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    state = driver.setup(cell)
    try:
        for seed in seeds:
            key = int(seed) % (2 ** 63)
            w = driver.window(state, seconds, key)
            yield seed, dict(driver.check_window(
                state, w, np.random.default_rng([key, 7])),
                trials=w.trials, attempted=w.attempted, failed=w.failed)
    finally:
        driver.close(state)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", choices=("bf16",))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, r in readings(args.workload, seeds, args.seconds,
                            args.control):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

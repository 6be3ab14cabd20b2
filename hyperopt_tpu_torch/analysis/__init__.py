"""Invariant analyzer suite of the PyTorch port — static checks gating
tier-1 over ``hyperopt_tpu_torch/``.

Eight AST-based checkers (see each module's docstring for the rules):

* :mod:`.capture_purity`      CP001–CP007 — no host sync under a CUDA
  graph capture or in a hosted dispatch half (the port's counterpart
  of the JAX package's jit-purity rules)
* :mod:`.lock_order`          LK001–LK003 — lock discipline, threaded layers
* :mod:`.registry_drift`      RD001–RD010 — env/fault/verb/metric/SLO names
* :mod:`.artifacts`           AH001       — artifact schema guards
* :mod:`.wire_protocol`       WP001–WP008 — client/dispatcher/WAL agreement
* :mod:`.replay_determinism`  RT001–RT004 — no nondeterminism on WAL replay
* :mod:`.exception_safety`    ES001–ES003 — release/surface/start discipline
* :mod:`.fault_coverage`      FP001       — every wire/WAL edge has a hook

Run as ``python -m hyperopt_tpu_torch.analysis [--json] [--baseline
FILE]`` or ``hyperopt-tpu-torch-show lint``; the tier-1 gate
(``tests/test_torch_analysis_gate.py``) runs the same :func:`run_repo`
against the checked-in ``baseline.json``.

This package imports **stdlib only** and never imports the modules it
analyzes (pure ``ast`` over source text): it runs where neither torch
nor JAX is installed and is immune to import-time side effects.
"""

from __future__ import annotations

import os
import time

from . import (artifacts, capture_purity, exception_safety,
               fault_coverage, lock_order, registry_drift,
               replay_determinism, wire_protocol)
from .core import Baseline, Finding, Project

__all__ = ["CHECKERS", "Baseline", "Finding", "Project",
           "run_project", "run_repo", "default_baseline_path"]

#: name -> (checker module, rule-id tuple), in report order.
CHECKERS = {
    "capture-purity": (capture_purity, capture_purity.RULES),
    "lock-order": (lock_order, lock_order.RULES),
    "registry-drift": (registry_drift, registry_drift.RULES),
    "artifact-honesty": (artifacts, artifacts.RULES),
    "wire-protocol": (wire_protocol, wire_protocol.RULES),
    "replay-determinism": (replay_determinism, replay_determinism.RULES),
    "exception-safety": (exception_safety, exception_safety.RULES),
    "fault-coverage": (fault_coverage, fault_coverage.RULES),
}


def default_baseline_path(root: str) -> str:
    return os.path.join(root, "hyperopt_tpu_torch", "analysis",
                        "baseline.json")


def run_project(project, checkers=None, timings=None) -> list:
    """Run the named checkers (default: all) over a built project.

    ``timings``, if given, is a dict filled with per-checker wall time
    in seconds (the ``--json`` report surfaces it so the tier-1 budget
    has per-checker attribution when it creeps).
    """
    findings = []
    for name, (mod, _rules) in CHECKERS.items():
        if checkers and name not in checkers:
            continue
        t0 = time.perf_counter()
        findings.extend(mod.check(project))
        if timings is not None:
            timings[name] = round(
                timings.get(name, 0.0) + time.perf_counter() - t0, 4)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
    return findings


def run_repo(root: str, checkers=None, timings=None) -> list:
    """Parse the repo at ``root`` and run the checkers over it."""
    return run_project(Project.from_dir(root), checkers=checkers,
                       timings=timings)

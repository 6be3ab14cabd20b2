#!/usr/bin/env python3
"""Time two versions of an EI kernel source against each other on one
NVIDIA GPU, in turns.

Run from the repository root::

    python3 chip_ei_ab.py --parent build/parent/ei_scores.cu [--out DIR]
    python3 chip_ei_ab.py --parent build/parent/ei_scores_mxu.cu [--out DIR]

``--parent`` is another version of a source in ``hyperopt_tpu_torch/csrc``
(for example the previous commit's, put under the git-ignored ``build/``);
its file name picks this tree's source it is timed against and the forms:
``ei_scores.cu`` holds K1 (f32) and K2 (bf16), ``ei_scores_mxu.cu`` K3
(mxu, the tensor-core form).  Each is compiled by the port's own build
code (``ops.ei_scores``: one ``nvcc`` each, both started together) into
``--out`` and loaded with ``ctypes``; the port's launch counts are not
touched.  At two shapes, the TPE step's slice (31 x 10,000 x (26 +
1,025), 1,022 live above) and the 2,048 bucket's (31 x 10,000 x (26 +
2,049), 1,030 live above as a prefix), every form of both versions is
held against the plain PyTorch version at ``chip_smoke.TOL``, then
timed with ``chip_smoke.cuda_ms``
(CUDA events, median of 25 windows of ``chip_smoke.LAUNCHES_PER_WINDOW``
back-to-back launches, after warm-up) in the order parent, new, new,
parent.

Prints the card's name and power limit first, each build's register
report, and one JSON object last, also written to ``ei_ab.json`` in
``--out`` (default ``build/ei_ab``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from hyperopt_tpu_torch.ops import ei_scores as ei_mod  # noqa: E402

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "hyperopt_tpu_torch" / "csrc"
SHAPES = {"slice": (31, cs.N_CAND, 26, 1025, 1022),
          "b2048": (31, cs.N_CAND, 26, 2049, 1030)}
# Source file name -> {form: (C entry point, ei_scores keywords)}.
FORMS = {"ei_scores.cu": {"f32": ("ei_scores_launch", {}),
                          "bf16": ("ei_scores_bf16_launch", {"bf16": True})},
         "ei_scores_mxu.cu": {"mxu": ("ei_scores_mxu_launch", {"mxu": True})}}


def kernel_form(entry_line, forms):
    """The form whose kernel a ``Compiling entry`` line of ``ptxas -v``
    names: the only form of a one-kernel source, else bf16 for the
    ``kBf16 = true`` instance of ``ei_scores.cu``'s template."""
    if len(forms) == 1:
        return next(iter(forms))
    return "bf16" if "ILb1E" in entry_line else "f32"


def build(sources, out_dir, forms):
    """``{name: source}`` -> ``{name: CDLL}``, all compiled together;
    prints each form's register and spill report."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: (out_dir / f"{name}.so",
                    ei_mod.compile_library(src, out_dir / f"{name}.so"))
             for name, src in sources.items()}
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        form = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                form = kernel_form(line, forms)
            elif "registers" in line or "spill" in line:
                print(f"build {name} {form}: {line.strip()}")
        libs[name] = ei_mod.load_library(
            lib, [entry for entry, _ in forms.values()])
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ei_ab")
    args = ap.parse_args(argv)
    forms = FORMS.get(args.parent.name)
    if forms is None:
        ap.error(f"--parent must be named one of {sorted(FORMS)}")
    if not torch.cuda.is_available():
        print("chip_ei_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    libs = build({"new": CSRC / args.parent.name, "parent": args.parent},
                 args.out, forms)
    result = {"card": card, "launches_per_window": cs.LAUNCHES_PER_WINDOW,
              "shapes": {}}
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    for shape, (c, n, kb, ka, live_a) in SHAPES.items():
        below = cs.random_mixture(rng, c, kb, kb - 1, dev)
        above = cs.random_mixture(rng, c, ka, live_a, dev)
        z = torch.as_tensor(rng.normal(0, 3, (c, n)).astype(np.float32),
                            device=dev)
        args_in = (z, *below, *above)
        ptrs = [t.data_ptr() for t in args_in]
        rows = {}
        for form, (entry, kw) in forms.items():
            ref = ei_mod.ei_scores_reference(*args_in, **kw)
            bound_ms, bound_by = cs.ei_bound_ms(z, below[0], above[0], form)
            outs = {name: torch.empty_like(z) for name in libs}

            def run(name, entry=entry, form=form):
                err = getattr(libs[name], entry)(
                    *ptrs, outs[name].data_ptr(), c, n, kb, ka, stream)
                if err != 0:
                    raise RuntimeError(f"{name} {form}: CUDA error {err}")

            row = {"bound_ms": bound_ms, "bound_by": bound_by}
            for name in libs:
                run(name)
                torch.cuda.synchronize()
                row[f"{name}_max_abs_err"], _, _ = cs.compare(
                    outs[name], ref, f"{name} {form} {shape}", cs.TOL[form])
            row["new_vs_parent_max_abs"] = \
                (outs["new"] - outs["parent"]).abs().max().item()
            turns = [(name, cs.cuda_ms(lambda name=name: run(name)))
                     for name in ("parent", "new", "new", "parent")]
            med = {k: float(np.median([t for nm, t in turns if nm == k]))
                   for k in ("parent", "new")}
            row.update(turns=turns, speedup=med["parent"] / med["new"],
                       new_over_bound=med["new"] / bound_ms)
            rows[form] = row
            print(f"{shape} {form}: {json.dumps(row)}")
        result["shapes"][shape] = rows
    (args.out / "ei_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

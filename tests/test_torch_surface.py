"""The port's public surface is the JAX package's.

Both packages' sources are parsed with ``ast``; neither is imported.  For
every module of ``hyperopt_tpu/`` (``ops/pallas_gmm.py`` maps to
``ops/ei_scores.py``, ``analysis/jit_purity.py`` to
``analysis/capture_purity.py``) the port's module of the same path must
exist and hold every public name the JAX module defines:

* top-level names: functions, classes, assignments, ``__all__`` entries,
  and the names a package ``__init__.py`` imports from its own package;
* public methods and class attributes, as ``Class.name``;
* the named parameters of each public function, method and class
  constructor that both packages define, as ``func(param=)``,
  ``Class.method(param=)`` or ``Class(param=)``.

A name the port does not have stands in :data:`JAX_ONLY`, keyed by
``(module, name)``, with a reason that names the port's counterpart in
backticks: a name of the port's module (an argument, a setter, a
function) or a path under ``hyperopt_tpu_torch/``.  These are JAX
machinery (threefry keys, environment readers, the persistent compile
cache, ``jax.sharding`` names, the XLA lowerings' arguments) and renamed
arguments, not features.  An entry the JAX package no longer has, or that
the port now has, fails as stale: the table can neither hide a new gap nor
outlive a closed one.  One case per JAX module.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "hyperopt_tpu"
PORT_PKG = ROOT / "hyperopt_tpu_torch"
MODULE_MAP = {"ops/pallas_gmm.py": "ops/ei_scores.py",
              "analysis/jit_purity.py": "analysis/capture_purity.py"}
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))

JAX_ONLY = {
    # The analyzers: capture purity is checked where jit purity was.
    ("analysis/__init__.py", "jit_purity"):
        "JAX's trace-purity checker; the port's `capture_purity` checks "
        "host syncs under a CUDA graph in its slot",
    # Meshes are torch.distributed device meshes over the process group.
    ("dispatch.py", "default_mesh(devices=)"):
        "a jax device list; the port's mesh spans the process group's "
        "ranks on `default_mesh(device_type=)`",
    # Environment readers: the port's switches are arguments and setters.
    ("faults.py", "configure_from_env"):
        "reads HYPEROPT_TPU_FAULTS; the port arms schedules with "
        "`configure` (and the workers' `--faults`)",
    ("history.py", "enabled"):
        "reads HYPEROPT_TPU_RESIDENT_HISTORY; the port's resident ring is "
        "the argument `tpe.suggest(resident=)`, see `device_history`",
    ("history.py", "resident_cap"):
        "reads HYPEROPT_TPU_RESIDENT_HISTORY_CAP; the port's cap is "
        "`device_history(lru_cap=)`",
    # jax.sharding placement of the resident buffers.
    ("history.py", "device_history(sharding=)"):
        "a jax.sharding.Sharding; the port places the ring with "
        "`device_history(device=)`",
    ("history.py", "device_history(shard_key=)"):
        "keys rings by sharding; the port keys them by "
        "`device_history(device=)`",
    ("history.py", "pregrow(shard_key=)"):
        "keys rings by sharding; the port's is `pregrow(device=)`",
    # The cost ledger records a jitted program's lowering.
    ("obs/costs.py", "record_compile(lower=)"):
        "a jax Lowered for XLA's cost analysis; the port records a "
        "build's `record_compile(memory_bytes=)`",
    ("obs/devtel.py", "slab_host(slab=)"):
        "one device tuple fetched by jax; the port's segment fetches its "
        "columns once and passes them as `slab_host(losses=)`, "
        "`slab_host(ei_best=)`, `slab_host(ties=)`",
    # The XLA lowerings' arguments.
    ("ops/gmm.py", "gmm_logpdf(exp_dtype=)"):
        "the XLA exp's dtype; the port's bf16 form is the EI kernel's "
        "`ops/ei_scores.py` (`ei_scores(bf16=)`)",
    ("ops/gmm.py", "gmm_sample(key=)"):
        "a threefry key; the port's draws are handed in as uniforms, "
        "`gmm_sample(u=)` and `gmm_sample(uc=)`",
    ("ops/gmm.py", "gmm_sample(n=)"):
        "the draw count of a jax key; the port's is the shape of "
        "`gmm_sample(u=)`",
    ("ops/gmm.py", "gmm_sample(comp_sampler=)"):
        "a string picking the component sampler; the port's is "
        "`gmm_sample(gumbel=)`",
    ("ops/gmm.py", "gmm_sample(onehot_batch=)"):
        "the one-hot matmul's batch on the TPU; the port gathers, "
        "`onehot_lookup`",
    ("ops/gmm.py", "onehot_lookup(batch=)"):
        "the one-hot matmul's batch on the TPU; the port's "
        "`onehot_lookup` is a gather",
    # Pallas: native on a TPU, interpreted elsewhere.  The port routes by
    # the tensor's device: the CUDA kernel, or its plain twin on the CPU.
    ("ops/pallas_gmm.py", "pallas_available"):
        "whether the backend is a TPU; the port's `ei_scores` routes by "
        "the tensor's device, after `build`",
    ("ops/pallas_gmm.py", "ei_scores_auto"):
        "native or interpreted Pallas; the port's `ei_scores` picks the "
        "CUDA kernel or `ei_scores_reference` by device",
    ("ops/pallas_gmm.py", "ei_scores(interpret=)"):
        "Pallas interpret mode; the port runs `ei_scores_reference` on "
        "CPU tensors",
    ("ops/pallas_gmm.py", "ei_scores(tile=)"):
        "the Pallas block size; the CUDA kernels' blocks are fixed in "
        "`csrc/ei_scores.cu`, the lowering is `ei_scores(mxu=)`",
    # torch.distributed takes its rendezvous under other names.
    ("parallel/multihost.py", "initialize(coordinator_address=)"):
        "jax.distributed's; the port's is `initialize(init_method=)`",
    ("parallel/multihost.py", "initialize(num_processes=)"):
        "jax.distributed's; the port's is `initialize(world_size=)`",
    ("parallel/multihost.py", "initialize(process_id=)"):
        "jax.distributed's; the port's is `initialize(rank=)`",
    # Threefry keys and XLA's compile cache.
    ("space.py", "prng_impl"):
        "reads HYPEROPT_TPU_PRNG to pick a jax key lowering; the port "
        "draws from a `make_generator` torch.Generator",
    ("space.py", "prng_key"):
        "a jax key; the port's is `make_generator`",
    ("space.py", "CompiledSpace.sample_traced"):
        "a jit-traceable sampler; the port's `CompiledSpace.sample` runs "
        "inside device mode's CUDA graph",
    ("space.py", "CompiledSpace.sample(key=)"):
        "a jax key; the port's is `CompiledSpace.sample(generator=)` or "
        "`CompiledSpace.sample(noise=)`",
    ("space.py", "ensure_persistent_compilation_cache"):
        "XLA's compile cache; the port's kernels are built once per "
        "source hash into build/ by `ops/ei_scores.py`",
}

# What this slice ported; none of it may hide in JAX_ONLY.
CLASSIC = [
    ("base.py", "miscs_update_idxs_vals"), ("base.py", "Trials.specs"),
    ("base.py", "Trials.average_best_error"), ("base.py", "Ctrl.checkpoint"),
    ("base.py", "Domain.short_str"), ("base.py", "Domain.true_loss"),
    ("space.py", "expr_to_config"),
    ("space.py", "CompiledSpace.active_path_pids"),
    ("space.py", "ParamSpec.is_categorical_like"),
    ("__init__.py", "NetstoreUnavailable"), ("pipeline.py", "MS_BUCKETS"),
    ("pipeline.py", "PipelinedExecutor(execution=)"),
    ("fmin.py", "FMinIter(verbose=)"),
]


def _params(fn, owner):
    a = fn.args
    return {f"{owner}({x.arg}=)" for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls") and not x.arg.startswith("_")}


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def surface(path):
    """``(names, params)`` of one module: public top-level names and
    ``Class.member`` entries; parameters keyed by their owner."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, params = set(), {}
    package = path.name == "__init__.py"
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
                params[node.name] = _params(node, node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__":
                        params[node.name] = _params(sub, node.name)
                    elif not sub.name.startswith("_"):
                        member = f"{node.name}.{sub.name}"
                        names.add(member)
                        params[member] = _params(sub, member)
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    names.update(f"{node.name}.{t}" for t in _targets(sub)
                                 if not t.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = _targets(node)
            names.update(t for t in targets if not t.startswith("_"))
            if "__all__" in targets and node.value is not None:
                names.update(n.value for n in ast.walk(node.value)
                             if isinstance(n, ast.Constant)
                             and isinstance(n.value, str))
        elif package and isinstance(node, ast.ImportFrom) and node.level:
            names.update(a.asname or a.name for a in node.names
                         if not (a.asname or a.name).startswith("_"))
    return names, params


def missing(module):
    """The JAX module's public entries the port's module lacks, and the
    port's whole surface as one set."""
    jax_names, jax_params = surface(JAX_PKG / module)
    port_names, port_params = surface(PORT_PKG / MODULE_MAP.get(module,
                                                                module))
    gaps = jax_names - port_names
    for owner, ps in jax_params.items():
        if owner in port_params:
            gaps |= ps - port_params[owner]
    port_all = port_names | set().union(*port_params.values(), set())
    jax_all = jax_names | set().union(*jax_params.values(), set())
    return gaps, jax_all, port_all


def test_the_port_has_every_jax_module():
    absent = [m for m in JAX_MODULES
              if not (PORT_PKG / MODULE_MAP.get(m, m)).exists()]
    assert not absent


def test_jax_only_names_jax_modules():
    assert {m for m, _ in JAX_ONLY} <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_surface_matches_jax(module):
    gaps, jax_all, port_all = missing(module)
    listed = {name for m, name in JAX_ONLY if m == module}
    assert gaps <= listed, (
        f"the port's {MODULE_MAP.get(module, module)} lacks "
        f"{sorted(gaps - listed)}: port them, or list each in JAX_ONLY "
        f"with its counterpart")
    stale = sorted(n for n in listed if n not in jax_all or n in port_all)
    assert not stale, f"stale JAX_ONLY entries of {module}: {stale}"
    for name in listed:
        reason = JAX_ONLY[(module, name)]
        named = re.findall(r"`([^`]+)`", reason)
        counterparts = [n for n in named
                        if n in port_all or n.split("(")[0] in port_all
                        or (PORT_PKG / n).exists()]
        assert counterparts, (
            f"JAX_ONLY[{module!r}, {name!r}] names no counterpart in the "
            f"port: {reason!r}")


def test_the_classic_surface_is_ported():
    for module, name in CLASSIC:
        gaps, _, port_all = missing(module)
        assert name in port_all and name not in gaps, (module, name)
        assert (module, name) not in JAX_ONLY, (module, name)

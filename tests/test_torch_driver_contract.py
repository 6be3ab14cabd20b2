"""``graft_entry_torch.py`` against ``__graft_entry__.py``.

Mirrors ``tests/test_driver_contract.py``'s first three cases on the
port, on the CPU:

* the surface: ``entry()`` builds its step and arguments, and
  ``dryrun_multichip`` exists;
* the entry step runs (eagerly: the port has no compile) and gives a
  ``(53,)`` row and activity mask with finite active values;
* ``dryrun_multichip(n, device="cpu")`` over 2 and 4 gloo rank processes
  prints the JAX twin's lines in the port's words: the ``(dp, sp)`` mesh,
  the trials evaluated and the global mesh.

And the port's own cases:

* handed JAX's ``entry()`` arguments and the uniforms its key draws, the
  port's step lands JAX's row (``tests/test_torch_tpe.py``'s tolerance)
  and the same activity mask;
* the dry run's global-mesh proposal, identical on every rank, is the
  local kernel's on the same history, computed here in one process;
* with the default device, both entry points raise where there is no
  card.

``TestBenchPreflight`` and ``TestLatestTpuArtifact`` of the JAX file test
``bench.py``, which has no twin in the port yet; they have no mirror here.
"""

import contextlib
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch import tpe as tpe_t
from hyperopt_tpu_torch.space import compile_space as compile_t
from test_torch_tpe import _jax_step_uniforms

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft_j  # noqa: E402
import graft_entry_torch as graft  # noqa: E402

CPU = "cpu"
_DRYRUNS: dict = {}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dryrun(n):
    """The printed lines of ``dryrun_multichip(n, device="cpu")``, run
    once per world size."""
    if n not in _DRYRUNS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            graft.dryrun_multichip(n, device=CPU)
        _DRYRUNS[n] = out.getvalue()
    return _DRYRUNS[n]


def test_entry_surface_smoke():
    fn, args = graft.entry(device=CPU)
    assert callable(fn)
    assert isinstance(args, tuple) and len(args) >= 1
    assert callable(graft.dryrun_multichip)


def test_entry_runs():
    fn, args = graft.entry(device=CPU)
    row, act = fn(*args)
    row, act = row.numpy(), act.numpy()
    assert row.shape == act.shape == (53,)   # 50 dims + branch + 2 children
    assert act.dtype == bool
    assert np.isfinite(row[act]).all()


@pytest.mark.parametrize("n, mesh", [(2, "{'dp': 2, 'sp': 1}"),
                                     (4, "{'dp': 2, 'sp': 2}")])
def test_dryrun_multichip(n, mesh):
    out = _dryrun(n)
    assert f"mesh={mesh}" in out
    assert "trials evaluated" in out
    assert "global mesh OK" in out
    assert "kernels_built_steady=0" in out


def test_entry_step_lands_jax_row():
    fn_j, args_j = graft_j.entry()
    key, hv, ha, hl, hok = args_j
    want, want_act = (np.asarray(a) for a in jax.jit(fn_j)(*args_j))
    kj = tpe_j.get_kernel(compile_j(graft_j._flagship_space()), 128, 1024,
                          25)
    fn, _ = graft.entry(device=CPU)
    # The same kernel entry() steps with (spaces compile once per
    # structure): its column groups are JAX's, so are the uniforms.
    kt = tpe_t.get_kernel(compile_t(graft._flagship_space()), 128, 1024, 25,
                          device=CPU)
    assert [list(g.pids) for g in kj.groups] == \
        [list(g.pids) for g in kt.groups]
    h = convert.history_from_numpy(
        {"vals": hv, "active": ha, "loss": hl, "ok": hok,
         "tids": np.arange(hv.shape[0])}, CPU)
    row, act = fn(_jax_step_uniforms(key, kj), h["vals"], h["active"],
                  h["loss"], h["ok"])
    row, act = row.numpy(), act.numpy()
    cs = compile_j(graft_j._flagship_space())
    ints = [p.pid for p in cs.params if p.is_int]
    np.testing.assert_array_equal(row[ints], want[ints])
    np.testing.assert_allclose(row, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(act, want_act)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_sharded_proposals_are_the_local_kernels(n):
    out = _dryrun(n)
    for step in ("sharded batched suggest done",
                 "multi-start over dp=", "sharded device-resident fmin"):
        (line,) = [ln for ln in out.splitlines() if step in ln]
        assert "the local" in line, line
    (line,) = [ln for ln in out.splitlines() if "global mesh OK" in ln]
    assert f"all-gather {list(range(n))}" in line
    assert "on every rank" in line
    prop = float(re.search(r"identical proposal (\S+)", line).group(1))
    assert prop == graft.global_proposal(n, CPU)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(2)

"""The EI scorer of the PyTorch port.

On the CPU ``ei_scores`` is its plain version, held here against the JAX
package's Pallas kernel run in interpret mode and against the XLA
``gmm_logpdf`` difference (plus the truncation normalizers the kernel
leaves out), at the tolerance of ``tests/test_pallas.py`` (rtol/atol
2e-4), with identical argmax.  The CUDA kernels themselves (f32, bf16 and
tensor-core lowerings) run only on the card: their test is
``tests_torch_cuda/test_torch_cuda_ei_scores.py``, and ``chip_smoke.py``
holds them against their plain versions at the TPE step's full shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.ops import gmm_logpdf
from hyperopt_tpu.ops.gmm import _log_trunc_mass
from hyperopt_tpu.ops.pallas_gmm import ei_scores as ei_jax
from hyperopt_tpu_torch.ops import ei_scores as ei_mod

SHAPES = [(3, 300, 8, 40), (1, 64, 2, 130), (8, 2048, 32, 128)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mixture(rng, c, k, k_live):
    logw = np.full((c, k), -np.inf, np.float32)
    for i in range(c):
        w = rng.random(k_live) + 0.1
        logw[i, :k_live] = np.log(w / w.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 3, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.3, 3, (c, k)), 1.0)
    return logw, mu.astype(np.float32), sg.astype(np.float32)


def _case(c, n, kb, ka, seed=0):
    rng = np.random.default_rng(seed)
    below = _mixture(rng, c, kb, max(1, kb - 1))
    above = _mixture(rng, c, ka, max(1, ka - 3))
    z = rng.normal(0, 3, (c, n)).astype(np.float32)
    return z, below, above


def _port(z, below, above):
    return ei_mod.ei_scores(*(torch.as_tensor(a) for a in
                              (z, *below, *above))).numpy()


@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_reference_matches_pallas_interpret(c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka)
    got = _port(z, below, above)
    want = np.asarray(ei_jax(*(jnp.asarray(a) for a in (z, *below, *above)),
                             tile=512 if n >= 512 else 128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(want, 1))


@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_reference_matches_xla_logpdf_difference(c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka, seed=1)
    got = _port(z, below, above)
    lo = jnp.full((c,), -jnp.inf)
    hi = jnp.full((c,), jnp.inf)
    sb = jax.jit(jax.vmap(gmm_logpdf, in_axes=(0,) * 6))
    bj = [jnp.asarray(a) for a in below]
    aj = [jnp.asarray(a) for a in above]
    want = np.asarray(sb(jnp.asarray(z), *bj, lo, hi)
                      - sb(jnp.asarray(z), *aj, lo, hi))
    norm = jax.jit(jax.vmap(_log_trunc_mass, in_axes=(0, 0, 0, None, None)))
    _, zb = norm(*bj, -jnp.inf, jnp.inf)
    _, za = norm(*aj, -jnp.inf, jnp.inf)
    shift = np.asarray(za - zb)[:, None]
    np.testing.assert_allclose(got + shift, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(want, 1))


def test_extreme_values_stay_finite(rng):
    logw = np.log(np.asarray([[0.5, 0.5], [0.9, 0.1]], np.float32))
    mu = np.asarray([[-50.0, 50.0], [0.0, 1e4]], np.float32)
    sg = np.asarray([[1e-3, 1e3], [0.5, 10.0]], np.float32)
    z = rng.uniform(-1e4, 1e4, (2, 256)).astype(np.float32)
    out = _port(z, (logw, mu, sg), (logw, mu, sg))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 0.0, atol=1e-3)


def test_dead_components_contribute_nothing():
    z, below, above = _case(2, 100, 5, 9)
    lw, mu, sg = (np.concatenate([a, np.full((2, 3), f, np.float32)], 1)
                  for a, f in zip(above, (-np.inf, 7.0, 0.5)))
    np.testing.assert_allclose(_port(z, below, (lw, mu, sg)),
                               _port(z, below, above), rtol=1e-6, atol=1e-6)


def test_rejects_bad_shapes():
    z, below, above = _case(2, 10, 3, 4)
    t = [torch.as_tensor(a) for a in (z, *below, *above)]
    with pytest.raises(ValueError):
        ei_mod.ei_scores(t[0], t[1][:1], *t[2:])
    with pytest.raises(ValueError):
        ei_mod.ei_scores(t[0], *t[1:5], t[5][:, :2], t[6])


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("available", [False, True])
def test_cuda_tensor_never_falls_back(monkeypatch, available, tmp_path):
    """A tensor on a CUDA device launches the kernel or raises, on every
    lowering: it must not reach the plain version, with or without a
    usable card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(ei_mod, "_libs", {})
    monkeypatch.setattr(ei_mod, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(ei_mod, "_nvcc", lambda: "/nonexistent/nvcc")

    def _fallback(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ei_mod, "ei_scores_reference", _fallback)
    z, below, above = _case(2, 10, 3, 4)
    t = [torch.Tensor._make_subclass(_ClaimsCuda, torch.as_tensor(a))
         for a in (z, *below, *above)]
    launches = ei_mod.ei_scores.launches
    by = dict(ei_mod.ei_scores.launches_by)
    for kw in ({}, {"bf16": True}, {"mxu": True}):
        with pytest.raises((RuntimeError, OSError)):
            ei_mod.ei_scores(*t, **kw)
    assert ei_mod.ei_scores.launches == launches
    assert ei_mod.ei_scores.launches_by == by



def test_concurrent_first_builds_compile_each_source_once(monkeypatch,
                                                           tmp_path):
    """Threads that reach ``build()`` together compile each source once:
    the later ones wait on the build lock and find the libraries built.
    ``nvcc`` and the loader are stubs; each stub compile takes long
    enough for the threads to overlap."""
    import os
    import sys
    import threading
    import time

    monkeypatch.setattr(ei_mod, "_libs", {})
    monkeypatch.setattr(ei_mod, "_BUILD_DIR", tmp_path)
    compiled, outs = [], []

    class _Proc:
        returncode = 0

        def __init__(self, out):
            self.out = out

        def communicate(self):
            time.sleep(0.2)
            with open(self.out, "wb") as f:
                f.write(b"lib")
            return "stub nvcc", None

    def compile_stub(source, out):
        compiled.append(source.name)
        outs.append(out.name)
        return _Proc(out)

    monkeypatch.setattr(ei_mod, "compile_library", compile_stub)
    monkeypatch.setattr(ei_mod, "load_library",
                        lambda path, entries: ("loaded", path.name))
    n_threads = 8
    barrier = threading.Barrier(n_threads)
    results, errors = [], []

    def run():
        try:
            barrier.wait(timeout=10)
            results.append(ei_mod.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(compiled) == sorted(p.name for p in ei_mod._SOURCES.values())
    # The temporary files are named by process and thread.
    idents = {t.ident for t in threads}
    assert all(any(f".{os.getpid()}.{i}." in o for i in idents) for o in outs)
    assert set(ei_mod._libs) == set(ei_mod._SOURCES)
    paths = [{k: v[0] for k, v in r.items()} for r in results]
    assert all(p == paths[0] for p in paths)
    # One build compiled (seconds > 0); every other found the libraries.
    assert sorted(s == 0.0 for r in results for _, s in r.values()) \
        == [False] * len(ei_mod._SOURCES) \
        + [True] * (n_threads - 1) * len(ei_mod._SOURCES)



_BUILD_CHILD = r"""
import sys, time
from pathlib import Path
from hyperopt_tpu_torch.ops import ei_scores as ei_mod

build_dir, log = Path(sys.argv[1]), Path(sys.argv[2])
ei_mod._BUILD_DIR = build_dir


class _Proc:
    returncode = 0

    def __init__(self, out):
        self.out = out

    def communicate(self):
        time.sleep(0.5)
        self.out.write_bytes(b"lib")
        return "stub nvcc", None


def compile_stub(source, out):
    with open(log, "a") as f:
        f.write(source.name + "\n")
    return _Proc(out)


ei_mod.compile_library = compile_stub
ei_mod.load_library = lambda path, entries: ("loaded", path.name)
while not (build_dir / "go").exists():
    time.sleep(0.01)
out = ei_mod.build()
print(sorted((k, v[0].name, v[1] > 0) for k, v in out.items()))
"""


def test_concurrent_first_builds_of_processes_compile_each_source_once(
        tmp_path):
    """Processes of one checkout that reach ``build()`` together (a driver
    and its file-store workers) compile each source once: the lock file
    in the build directory holds the others until the libraries stand.
    ``nvcc`` and the loader are stubs that write to a shared log; the
    children start together on a flag file."""
    import subprocess
    import sys
    import time

    build_dir, log = tmp_path / "build", tmp_path / "compiled.log"
    build_dir.mkdir()
    n_procs = 3
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_CHILD, str(build_dir), str(log)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(n_procs)]
    time.sleep(1.0)
    (build_dir / "go").touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(log.read_text().split()) == sorted(
        p.name for p in ei_mod._SOURCES.values())
    # Every process loaded the same libraries; one of them compiled.
    lines = [o.strip().splitlines()[-1] for o, _ in outs]
    names = {tuple((k, n) for k, n, _ in eval(line)) for line in lines}
    assert len(names) == 1
    assert sorted(any(c for _, _, c in eval(line)) for line in lines) \
        == [False] * (n_procs - 1) + [True]

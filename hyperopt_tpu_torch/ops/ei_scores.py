"""Fused EI scoring of TPE candidates: the CUDA kernels and their plain twins.

Counterpart of ``hyperopt_tpu/ops/pallas_gmm.py``.  For a group of ``C``
continuous columns the TPE step scores ``n`` candidates per column as

    ei[c, i] = LSE_k(cb_b - ½((z - mu_b)/sg_b)²) - LSE_k(cb_a - ½((z - mu_a)/sg_a)²)

with ``cb = logw - log(sg) - ½log(2π)``: the log-density ratio of the below
and above Parzen mixtures, without the per-column truncation normalizers
(constants along the candidate axis, so they cancel in the argmax).

Three lowerings of the same function, as in the JAX package:

- ``f32`` (default): ``csrc/ei_scores.cu``, ``ei_scores_launch``;
- ``bf16`` (``bf16=True``): the same kernel with ``t = (z - mu)/sg`` rounded
  to bfloat16 after the subtraction and after the division, the rest in
  float32 (``ei_scores_bf16_launch``);
- ``mxu`` (``mxu=True``, which ignores ``bf16``): the exponent as the
  quadratic ``a2·z² + a1·z + a0`` on the tensor cores in 3×TF32,
  ``csrc/ei_scores_mxu.cu``.

:func:`ei_scores` launches the kernel for CUDA tensors and uses
:func:`ei_scores_reference` for CPU tensors; there is no other route.  The
kernels are compiled with ``nvcc`` at first use, one plain-C shared library
per source, all sources at once, under ``build/hyperopt_tpu_torch/`` (named
by the hash of the source), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {"ei_scores": _CSRC / "ei_scores.cu",
            "ei_scores_mxu": _CSRC / "ei_scores_mxu.cu"}
# Lowering -> (library, C entry point).  Every entry takes the same
# arguments.
_ENTRIES = {"f32": ("ei_scores", "ei_scores_launch"),
            "bf16": ("ei_scores", "ei_scores_bf16_launch"),
            "mxu": ("ei_scores_mxu", "ei_scores_mxu_launch")}
LOWERINGS = tuple(_ENTRIES)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyperopt_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest [C, chunk, K] temporary the plain version materializes at once.
_REF_ELEMS = 1 << 24
# Finite floor of the quadratic's constant term (pallas_gmm.py's -1e30).
_A0_FLOOR = -1e30

_libs: dict = {}
#: Compiler report (registers, shared memory, spills) of each library
#: built by this process.
build_log: dict = {}


def lowering(mxu=False, bf16=False) -> str:
    """The lowering that ``ei_scores(..., mxu=, bf16=)`` runs."""
    return "mxu" if mxu else ("bf16" if bf16 else "f32")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _lib_path(name, src: bytes) -> Path:
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"{name}_{digest[:16]}.so"


def compile_library(source, out) -> subprocess.Popen:
    """Start ``nvcc`` with the port's flags on the CUDA ``source``, writing
    the shared library ``out``.  Returns the process; its output (the
    compiler's report) is on its ``stdout`` pipe."""
    return subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-o", str(out),
                             str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def load_library(path, entries) -> ctypes.CDLL:
    """Load a kernel library and declare the argument types of its
    ``entries`` (names of C entry points, which all take the same
    arguments)."""
    dll = ctypes.CDLL(str(path))
    for entry in entries:
        fn = getattr(dll, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return dll


def build() -> dict:
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all started together; load them all.

    Returns ``{library: (path, seconds spent compiling it)}`` (0.0 for a
    library that already existed for its exact source)."""
    started = {}
    for name, source in _SOURCES.items():
        path = _lib_path(name, source.read_bytes())
        if path.exists():
            started[name] = (path, None, None, 0.0)
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = compile_library(source, tmp)
        started[name] = (path, tmp, proc, time.perf_counter())
    out = {}
    for name, (path, tmp, proc, t0) in started.items():
        seconds = 0.0
        if proc is not None:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            build_log[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SOURCES[name]}:\n{log}")
            os.replace(tmp, path)
        out[name] = (path, seconds)
    for name, (path, _seconds) in out.items():
        if name not in _libs:
            _libs[name] = load_library(
                path, [e for lib, e in _ENTRIES.values() if lib == name])
    return out


def _check(z, mixtures):
    if z.dim() != 2:
        raise ValueError(f"z must be [C, n], got shape {tuple(z.shape)}")
    c = z.shape[0]
    for name, t in zip(("logw_b", "mu_b", "sg_b", "logw_a", "mu_a", "sg_a"),
                       mixtures):
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if t.dim() != 2 or t.shape[0] != c:
            raise ValueError(f"{name} must be [{c}, K], got {tuple(t.shape)}")
    kb, ka = mixtures[0].shape[1], mixtures[3].shape[1]
    for name, t, k in zip(("mu_b", "sg_b", "mu_a", "sg_a"),
                          (mixtures[1], mixtures[2], mixtures[4], mixtures[5]),
                          (kb, kb, ka, ka)):
        if t.shape[1] != k:
            raise ValueError(f"{name} has {t.shape[1]} components, "
                             f"its logw {k}")
    if kb == 0 or ka == 0:
        raise ValueError("each mixture needs at least one component")


def ei_scores(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, mxu=False,
              bf16=False):
    """EI scores ``f32[C, n]`` of candidates ``z`` (fit space).

    ``logw_*/mu_*/sg_*``: ``f32[C, K*]`` below/above mixtures, ``-inf``
    log-weights on dead components (any mu and sigma).  ``mxu``/``bf16``
    pick the lowering (:func:`lowering`).  A CUDA ``z`` launches that
    lowering's kernel (and adds one to ``ei_scores.launches`` and to
    ``ei_scores.launches_by[lowering]``) or raises; a CPU ``z`` goes to
    :func:`ei_scores_reference`.

    Inside a CUDA-graph capture (device mode, ``device.py``) the call
    records the launch into the graph without running it: it adds one to
    ``ei_scores.recorded_by[lowering]`` instead.  Every replay of the
    graph then runs the kernel without passing through here, so neither
    count sees those runs; a profiler does."""
    mixtures = (logw_b, mu_b, sg_b, logw_a, mu_a, sg_a)
    _check(z, mixtures)
    if z.device.type == "cpu":
        return ei_scores_reference(z, *mixtures, mxu=mxu, bf16=bf16)
    if z.device.type != "cuda":
        raise ValueError(f"ei_scores runs on cuda or cpu, not {z.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("ei_scores got a CUDA tensor but CUDA is not "
                           "available")
    for t in (z, *mixtures):
        if t.dtype != torch.float32:
            raise TypeError(f"ei_scores kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ei_scores kernel takes contiguous tensors")
    c, n = z.shape
    if c > 65535:
        raise ValueError(f"ei_scores kernel takes at most 65535 columns, "
                         f"got {c}")
    low = lowering(mxu, bf16)
    lib_name, entry = _ENTRIES[low]
    if lib_name not in _libs:
        build()
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        recording = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = getattr(_libs[lib_name], entry)(
            z.data_ptr(), logw_b.data_ptr(), mu_b.data_ptr(),
            sg_b.data_ptr(), logw_a.data_ptr(), mu_a.data_ptr(),
            sg_a.data_ptr(), out.data_ptr(), c, n, logw_b.shape[1],
            logw_a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"ei_scores {low} kernel launch failed: CUDA "
                           f"error {err}")
    if recording:
        ei_scores.recorded_by[low] += 1
    else:
        ei_scores.launches += 1
        ei_scores.launches_by[low] += 1
    return out


ei_scores.launches = 0
ei_scores.launches_by = dict.fromkeys(LOWERINGS, 0)
ei_scores.recorded_by = dict.fromkeys(LOWERINGS, 0)


def reset_launches():
    """Set the total and per-lowering launch counts, and the counts of
    launches recorded into graphs, to 0."""
    ei_scores.launches = 0
    ei_scores.launches_by = dict.fromkeys(LOWERINGS, 0)
    ei_scores.recorded_by = dict.fromkeys(LOWERINGS, 0)


def _terms_f32(logw, mu, sg):
    live = logw > -math.inf
    sg = torch.where(live, sg, torch.ones_like(sg))
    mu = torch.where(live, mu, torch.zeros_like(mu))
    cb = torch.where(live, logw - torch.log(sg) - _HALF_LOG_2PI,
                     torch.full_like(logw, -math.inf))

    def terms(z):
        t = (z[:, :, None] - mu[:, None, :]) / sg[:, None, :]
        return cb[:, None, :] - 0.5 * t * t

    return terms


def _terms_bf16(logw, mu, sg):
    live = logw > -math.inf
    cb = torch.where(live, logw - torch.log(sg) - _HALF_LOG_2PI,
                     torch.full_like(logw, -math.inf))
    mu_h = torch.where(live, mu, torch.zeros_like(mu)).bfloat16()
    sg_h = torch.where(live, sg, torch.ones_like(sg)).bfloat16()

    def terms(z):
        # Two bf16 ops, each rounded to bf16; the square and the rest f32.
        t = ((z.bfloat16()[:, :, None] - mu_h[:, None, :])
             / sg_h[:, None, :]).float()
        return cb[:, None, :] + (-0.5 * t * t)

    return terms


def mxu_coefficients(logw, mu, sg):
    """``(a2, a1, a0)`` of the quadratic exponent, each ``f32[C, K]``:
    ``a2 = -½/σ², a1 = μ/σ², a0 = max(cb - ½μ²/σ², -1e30)``; dead
    components get ``(0, 0, -1e30)``."""
    live = logw > -math.inf
    sg = torch.where(live, sg, torch.ones_like(sg))
    mu = torch.where(live, mu, torch.zeros_like(mu))
    cb = logw - torch.log(sg) - _HALF_LOG_2PI
    inv2 = 1.0 / (sg * sg)
    zero = torch.zeros_like(inv2)
    a2 = torch.where(live, -0.5 * inv2, zero)
    a1 = torch.where(live, mu * inv2, zero)
    a0 = torch.where(live, torch.clamp_min(cb - 0.5 * mu * mu * inv2,
                                           _A0_FLOOR),
                     torch.full_like(inv2, _A0_FLOOR))
    return a2, a1, a0


def _terms_mxu(logw, mu, sg):
    a2, a1, a0 = (a[:, None, :] for a in mxu_coefficients(logw, mu, sg))

    def terms(z):
        zz = z[:, :, None]
        return a2 * (zz * zz) + a1 * zz + a0

    return terms


def ei_scores_reference(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a,
                        mxu=False, bf16=False):
    """Plain PyTorch version of :func:`ei_scores` for each lowering (same
    math, any device).

    Materializes ``[C, chunk, K]`` broadcasts, chunked over candidates so
    that each stays under ``2**24`` elements.  Dead components add exactly
    0 whatever their mu and sigma."""
    terms = {"f32": _terms_f32, "bf16": _terms_bf16,
             "mxu": _terms_mxu}[lowering(mxu, bf16)]
    below = terms(logw_b, mu_b, sg_b)
    above = terms(logw_a, mu_a, sg_a)
    c, n = z.shape
    k = max(logw_b.shape[1], logw_a.shape[1])
    chunk = max(1, _REF_ELEMS // max(1, c * k))
    out = []
    for i in range(0, n, chunk):
        zc = z[:, i:i + chunk]
        out.append(torch.logsumexp(below(zc), dim=-1)
                   - torch.logsumexp(above(zc), dim=-1))
    return torch.cat(out, dim=1) if out else z.new_empty((c, 0))

"""Fused EI scoring of TPE candidates: the CUDA kernel and its plain twin.

Counterpart of ``hyperopt_tpu/ops/pallas_gmm.py``.  For a group of ``C``
continuous columns the TPE step scores ``n`` candidates per column as

    ei[c, i] = LSE_k(cb_b - ½((z - mu_b)/sg_b)²) - LSE_k(cb_a - ½((z - mu_a)/sg_a)²)

with ``cb = logw - log(sg) - ½log(2π)``: the log-density ratio of the below
and above Parzen mixtures, without the per-column truncation normalizers
(constants along the candidate axis, so they cancel in the argmax).

:func:`ei_scores` launches ``csrc/ei_scores.cu`` for CUDA tensors and uses
:func:`ei_scores_reference` for CPU tensors; there is no other route.  The
kernel is compiled with ``nvcc`` at first use into a plain-C shared library
under ``build/hyperopt_tpu_torch/`` (named by the hash of the source) and
bound with ``ctypes``.
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
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ei_scores.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyperopt_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest [C, chunk, K] temporary the plain version materializes at once.
_REF_ELEMS = 1 << 24

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> tuple[Path, float]:
    """Compile the kernel if its library is missing; load it.

    Returns ``(library path, seconds spent compiling)`` (0.0 when the
    library for this exact source already existed).  ``build_log`` keeps
    the compiler's report (registers, shared memory, spills)."""
    global _lib, build_log
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib_path = _BUILD_DIR / f"ei_scores_{digest[:16]}.so"
    seconds = 0.0
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(_SOURCE)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{build_log}")
        os.replace(tmp, lib_path)
    if _lib is None:
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.ei_scores_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return lib_path, seconds


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


def ei_scores(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a):
    """EI scores ``f32[C, n]`` of candidates ``z`` (fit space).

    ``logw_*/mu_*/sg_*``: ``f32[C, K*]`` below/above mixtures, ``-inf``
    log-weights on dead components.  A CUDA ``z`` launches the kernel (and
    adds one to ``ei_scores.launches``) or raises; a CPU ``z`` goes to
    :func:`ei_scores_reference`."""
    mixtures = (logw_b, mu_b, sg_b, logw_a, mu_a, sg_a)
    _check(z, mixtures)
    if z.device.type == "cpu":
        return ei_scores_reference(z, *mixtures)
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
    if _lib is None:
        build()
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = _lib.ei_scores_launch(
            z.data_ptr(), logw_b.data_ptr(), mu_b.data_ptr(),
            sg_b.data_ptr(), logw_a.data_ptr(), mu_a.data_ptr(),
            sg_a.data_ptr(), out.data_ptr(), c, n, logw_b.shape[1],
            logw_a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"ei_scores kernel launch failed: CUDA error {err}")
    ei_scores.launches += 1
    return out


ei_scores.launches = 0


def _mixture_lse(z, logw, mu, sg):
    cb = logw - torch.log(sg) - _HALF_LOG_2PI
    t = (z[:, :, None] - mu[:, None, :]) / sg[:, None, :]
    return torch.logsumexp(cb[:, None, :] - 0.5 * t * t, dim=-1)


def ei_scores_reference(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a):
    """Plain PyTorch version of :func:`ei_scores` (same math, any device).

    Materializes ``[C, chunk, K]`` broadcasts, chunked over candidates so
    that each stays under ``2**24`` elements."""
    c, n = z.shape
    k = max(logw_b.shape[1], logw_a.shape[1])
    chunk = max(1, _REF_ELEMS // max(1, c * k))
    out = []
    for i in range(0, n, chunk):
        zc = z[:, i:i + chunk]
        out.append(_mixture_lse(zc, logw_b, mu_b, sg_b)
                   - _mixture_lse(zc, logw_a, mu_a, sg_a))
    return torch.cat(out, dim=1) if out else z.new_empty((c, 0))

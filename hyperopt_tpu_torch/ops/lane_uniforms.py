"""Every lane's uniforms of one device-mode step in one launch, with the
bits of ``torch.rand`` on the card.

Replaces no TPU kernel (``csrc/lane_uniforms.cu`` says why it exists and
what bounds it).  Device mode's step (``device._Segment``) draws, for
each lane ``j`` and trial seed ``s``, the startup sheets
(``CompiledSpace.draw_uniforms(1, g)``) from one CUDA generator and the
TPE sheets (``_TpeKernel.draw_noise(g)``) from a second, both seeded
with ``s % 2**32``.  The hosted step and the benchmark's plain reference
draw those sheets with ``torch.rand``; this module writes the same bits
for every sheet of every lane into the stacked ``[L, ...]`` buffers the
step reads, from one int64 ``[L]`` buffer of seeds.

``torch.rand``'s layout on CUDA (ATen's ``calc_execution_policy`` and
``distribution_elementwise_grid_stride_kernel``): blocks of
:data:`BLOCK` threads, ``G = min(ceil(numel / 256), SMs ×
maxThreadsPerSM / 256)`` of them (:func:`grid_blocks`); virtual thread
``idx < 256·G`` runs ``curand_init(seed, idx, offset)`` and, per pass
``p``, one ``curand_uniform4``, whose lane ``ii`` lands at element ``idx
+ p·4·256·G + ii·256·G`` when that lies below ``numel``.  The
generator's offset is 0 after ``manual_seed`` and each sheet moves it by
:func:`offset_step`, so a sheet's offset is the sum of the steps of the
sheets its generator drew before it; an empty sheet draws nothing.

:class:`DrawPlan` lays the sheets out once per segment: one unit per
(sheet, pass), blocks of :data:`CHUNK` items over the units.
:func:`draw` launches the kernel for a CUDA plan (adding one to
``draw.launches``, or to ``draw.recorded_by`` inside a graph capture) or
raises; a CPU plan runs :func:`uniform_sheet_reference`, the plain
PyTorch version (integer Philox4x32-10, ``curand_init``'s skip-ahead,
the same layout), sheet by sheet.  The library is built with the EI
kernels' (``ei_scores.build``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import ei_scores as _ei

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "draw",
)

#: ATen's block of a ``torch.rand`` launch, and its unroll (the four
#: floats of a ``curand_uniform4``).
BLOCK = 256
UNROLL = 4
#: Items (virtual threads of one pass) per block of the kernel: 256
#: threads of 4 items (``csrc/lane_uniforms.cu``).
CHUNK = 1024
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_COUNT_LOCK = threading.Lock()


def grid_blocks(numel, n_sm, threads_per_sm):
    """Blocks of ``torch.rand``'s launch for ``numel`` floats on a card of
    ``n_sm`` SMs of ``threads_per_sm`` threads (ATen's
    ``calc_execution_policy``)."""
    return min(-(-int(numel) // BLOCK),
               int(n_sm) * (int(threads_per_sm) // BLOCK))


def offset_step(numel, grid):
    """How far one ``torch.rand`` of ``numel > 0`` floats on ``grid``
    blocks moves its generator's Philox offset."""
    return ((int(numel) - 1) // (BLOCK * int(grid) * UNROLL) + 1) * UNROLL


def card_shape(device):
    """``(SMs, max threads per SM)`` of a CUDA device, as ATen reads
    them."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.max_threads_per_multi_processor


class DrawPlan:
    """The sheets of one launch and their layout.

    ``streams``: ``[(slot, [out, ...]), ...]``, one entry per generator
    stream: the seed it reads (``seeds[slot]``) and the sheets it draws,
    in order, each a contiguous float32 tensor written in place.  Every
    stream starts at offset 0 (a freshly seeded generator).  ``n_sm`` and
    ``threads_per_sm`` are the card's (:func:`card_shape`; any values for
    a CPU plan, whose layout is then that card's).

    ``sheets`` lists ``(slot, offset, numel, grid, out)`` per non-empty
    sheet; ``philox_blocks`` counts the Philox blocks the layout computes
    (one per virtual thread and pass that lands a float), ``n_blocks`` the
    kernel's blocks.  On CUDA ``units`` (int64 ``[U, 8]``: out address,
    slot, Philox counter, numel, threads, base, items, first block) and
    ``block_unit`` (int32 ``[blocks]``) are the kernel's tables, uploaded
    here once."""

    def __init__(self, streams, n_sm, threads_per_sm):
        self.sheets = []
        dev = None
        for slot, outs in streams:
            offset = 0
            for out in outs:
                if out.dtype != torch.float32 or not out.is_contiguous():
                    raise ValueError("a sheet is a contiguous float32 "
                                     "tensor")
                if dev is None:
                    dev = out.device
                elif out.device != dev:
                    raise ValueError(f"sheets on {dev} and {out.device}")
                numel = out.numel()
                if numel == 0:
                    continue
                if numel > 2 ** 31 - 1:
                    raise ValueError(f"a sheet of {numel} floats: torch.rand "
                                     f"splits those into 32-bit launches")
                grid = grid_blocks(numel, n_sm, threads_per_sm)
                self.sheets.append((int(slot), offset, numel, grid, out))
                offset += offset_step(numel, grid)
        self.device = dev
        self.n_slots = 1 + max((s[0] for s in self.sheets), default=-1)
        units, block_unit = [], []
        for slot, offset, numel, grid, out in self.sheets:
            threads = BLOCK * grid
            for p in range((numel - 1) // (threads * UNROLL) + 1):
                base = p * threads * UNROLL
                items = min(threads, numel - base)
                n = -(-items // CHUNK)
                units.append((out.data_ptr(), slot, offset // UNROLL + p,
                              numel, threads, base, items, len(block_unit)))
                block_unit += [len(units) - 1] * n
        self.philox_blocks = sum(u[6] for u in units)
        self.n_blocks = len(block_unit)
        if self.n_blocks > 2 ** 31 - 1:
            raise ValueError(f"{self.n_blocks} blocks exceed one launch")
        if dev is None or dev.type != "cuda":
            return
        self.units = torch.as_tensor(np.asarray(units, np.int64), device=dev)
        self.block_unit = torch.as_tensor(np.asarray(block_unit, np.int32),
                                          device=dev)


def draw(plan, seeds):
    """Draw every sheet of ``plan`` in place from ``seeds`` (int64, one
    per slot, on the plan's device, read as unsigned).  A CUDA plan
    launches the kernel once, or raises; a CPU plan runs
    :func:`uniform_sheet_reference` per sheet.

    Inside a CUDA-graph capture the launch is recorded into the graph:
    it adds to ``draw.recorded_by``, not ``draw.launches``, and replays
    pass through neither."""
    if seeds.dtype != torch.int64 or not seeds.is_contiguous():
        raise ValueError("seeds is a contiguous int64 tensor")
    if seeds.numel() < plan.n_slots:
        raise ValueError(f"{seeds.numel()} seeds for {plan.n_slots} slots")
    if plan.device is None:
        return
    if seeds.device != plan.device:
        raise ValueError(f"seeds on {seeds.device}, the sheets on "
                         f"{plan.device}")
    if plan.device.type == "cpu":
        for slot, offset, numel, grid, out in plan.sheets:
            out.view(-1).copy_(uniform_sheet_reference(
                seeds[slot], offset, numel, grid))
        return
    if plan.device.type != "cuda":
        raise ValueError(f"lane uniforms run on cuda or cpu, not "
                         f"{plan.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("lane uniforms got CUDA sheets but CUDA is not "
                           "available")
    with torch.cuda.device(plan.device):
        recording = torch.cuda.is_current_stream_capturing()
        _launch(plan.units, plan.block_unit, seeds, plan.n_blocks)
    with _COUNT_LOCK:
        if recording:
            draw.recorded_by += 1
        else:
            draw.launches += 1


draw.launches = 0
draw.recorded_by = 0


def _launch(units, block_unit, seeds, n_blocks):
    """One launch of ``lane_uniforms_launch`` on the current stream;
    raises when CUDA refuses it."""
    if "lane_uniforms" not in _ei._libs:
        _ei.build()
    stream = torch.cuda.current_stream().cuda_stream
    err = _ei._libs["lane_uniforms"].lane_uniforms_launch(
        units.data_ptr(), block_unit.data_ptr(), seeds.data_ptr(),
        int(n_blocks), stream)
    if err != 0:
        raise RuntimeError(f"lane uniforms kernel launch failed: CUDA error "
                           f"{err}")


def reset_launches():
    """Set ``draw.launches`` and ``draw.recorded_by`` to 0."""
    with _COUNT_LOCK:
        draw.launches = 0
        draw.recorded_by = 0


def _mulhilo(m, x):
    """``(hi, lo)`` 32-bit words of ``m · x`` for a constant ``m`` and
    int64 ``x`` holding 32-bit values, in 48-bit partial products."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    s = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (s >> 32), s & _M32


def philox4x32_10(ctr, sub, key):
    """curand's Philox4x32-10 of counter words ``(ctr lo, ctr hi, sub lo,
    sub hi)`` under ``key``'s two words: four int64 tensors holding 32-bit
    words.  ``ctr`` and ``sub`` are int64 tensors and ``key`` an int64
    tensor or an int, each 64 bits read as unsigned."""
    c0, c1 = ctr & _M32, (ctr >> 32) & _M32
    c2, c3 = sub & _M32, (sub >> 32) & _M32
    k0, k1 = key & _M32, (key >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def to_uniform(x):
    """curand's float ``x · 2^-32 + 2^-33`` in (0, 1] of 32-bit words
    ``x`` (int64), with 1 mapped to 0 as ``torch.rand`` does."""
    v = x.to(torch.float32) * 2.0 ** -32 + 2.0 ** -33
    return torch.where(v == 1.0, torch.zeros_like(v), v)


def uniform_sheet_reference(seed, offset, numel, grid, device="cpu"):
    """Plain PyTorch version of one sheet: ``f32[numel]``, what
    ``torch.rand(numel)`` on a CUDA generator seeded with ``seed`` (an int
    or an int64 tensor) and at Philox offset ``offset`` (a multiple of 4)
    writes when ATen launches it on ``grid`` blocks
    (:func:`grid_blocks`)."""
    threads = BLOCK * grid
    out = torch.empty(numel, dtype=torch.float32, device=device)
    idx = torch.arange(threads, dtype=torch.int64, device=device)
    for p in range((numel - 1) // (threads * UNROLL) + 1 if numel else 0):
        words = philox4x32_10(torch.full_like(idx, offset // UNROLL + p),
                              idx, seed)
        for ii, w in enumerate(words):
            li = idx + (p * UNROLL + ii) * threads
            keep = li < numel
            out[li[keep]] = to_uniform(w[keep])
    return out

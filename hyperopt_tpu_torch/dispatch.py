"""One dispatch substrate: sharding × fleet lanes × pipeline depth × head.

Counterpart of ``hyperopt_tpu/dispatch.py``.  Every suggest path acquires
its kernel here:

* **sharding**: the EI candidate axis split over the ``sp`` dimension of a
  ``torch.distributed`` device mesh (:class:`ShardedTpeKernel`: one slice
  of the candidates scored per rank, the argmax reduced by one collective
  per step);
* **fleet lanes**: ``fleet.CohortScheduler`` acquires its kernel through
  :func:`get_kernel`, so a cohort's lanes run against the sharded kernel
  when a mesh is active;
* **pipeline depth**: :func:`suggest_dispatch` returns ``tpe``'s handles,
  so the four async halves and ``fmin``'s depth-D loop drive it as they
  drive the local path;
* **head**: ``tpe.suggest_dispatch`` consults :func:`active_mesh` and
  delegates here, so ``tpe``, ``tpe_quantile`` and every TPE-family head of
  ``backends/contract.py`` inherit the mesh.

**Mode.**  :func:`set_mode` takes the place of the JAX package's
environment switch:

* ``"auto"`` (default): sharded when a mesh was registered
  (:func:`set_default_mesh`, done by ``parallel.multihost.initialize``) or
  passed; local otherwise;
* ``"sharded"``: build a mesh over the process group's ranks
  (:func:`default_mesh`) and shard every suggest;
* ``"local"``: never shard, even with a registered mesh.

An unknown spelling raises ``ValueError``; the JAX package falls back to
``"auto"`` silently instead.

**A mesh** is a ``torch.distributed.device_mesh.DeviceMesh`` with the
dimension names ``("dp", "sp")``: ``sp`` (:data:`CAND_AXIS`) splits the
candidates, ``dp`` (:data:`START_AXIS`) the independent runs (restarts,
fleet lanes, multi-start).  :func:`default_mesh` builds one over the
initialized process group: NCCL on the card, gloo on the CPU.

**The sharded step is a collective.**  Every rank of the mesh calls the
same suggest with the same history and seed (SPMD): each holds the whole
history, makes the same fits and draws every candidate from the same
generator, so its candidate streams are the local kernel's; it then
scores only its contiguous slice ``[r·n/W, (r+1)·n/W)`` (for density
columns, the EI kernel on that slice on its own device) and one
all-gather over the ``sp`` group reduces each sheet's ``(best, index,
ties)``: the best score is the maximum over ranks, equal scores go to the
lowest global index (as ``torch.argmax`` does locally), the ties add up
over the ranks that hold the best.  The proposals are the local kernel's
bits.  A rank that does not enter the collective hangs the others.

Kernels with a mesh live in ``cs._dispatch_kernels``, keyed by the local
kernel's full key plus the mesh layout (:func:`_mesh_key`: dimension
names, shape, ranks, device type; never ``id(mesh)``), and feed the same
``kernel_cache_stats`` counters as the local cache.  Counters:
``dispatch.sharded``, ``dispatch.local`` and
``dispatch.fallback_indivisible``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import base, rand
from . import tpe as _tpe
from .obs.metrics import registry as _metrics_registry
from .space import CompiledSpace, make_generator, resolve_device

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "ShardedTpeKernel._cand_slice",
    "ShardedTpeKernel._reduce_stats",
)

CAND_AXIS = "sp"    # the candidate axis
START_AXIS = "dp"   # independent runs
_MODES = ("auto", "sharded", "local")

__all__ = ["CAND_AXIS", "START_AXIS", "ShardedTpeKernel", "active_mesh",
           "clear_default_mesh", "default_mesh", "get_kernel", "mode",
           "multi_start_suggest", "set_default_mesh", "set_mode",
           "suggest_dispatch"]


# ---------------------------------------------------------------------------
# mode + mesh registry
# ---------------------------------------------------------------------------

_MESH_LOCK = threading.Lock()
_MODE = "auto"
_DEFAULT_MESH = None   # registered by multihost.initialize() / tests
_MODE_MESH = None      # built lazily in "sharded" mode


def mode() -> str:
    """The routing mode (:func:`set_mode`)."""
    return _MODE


def set_mode(name: str) -> str:
    """Set the routing mode: ``"auto"``, ``"sharded"`` or ``"local"``.
    Returns the previous mode."""
    global _MODE
    key = str(name).strip().lower()
    if key not in _MODES:
        raise ValueError(f"dispatch mode must be one of {_MODES}, got "
                         f"{name!r}")
    with _MESH_LOCK:
        prev, _MODE = _MODE, key
    return prev


def set_default_mesh(mesh):
    """Register the process-wide mesh (``"auto"`` mode shards once one is
    registered); ``None`` unregisters.  Returns ``mesh``."""
    global _DEFAULT_MESH
    with _MESH_LOCK:
        _DEFAULT_MESH = mesh
    return mesh


def clear_default_mesh():
    """Drop the registered mesh and the one ``"sharded"`` mode built."""
    global _DEFAULT_MESH, _MODE_MESH
    with _MESH_LOCK:
        _DEFAULT_MESH = None
        _MODE_MESH = None


def active_mesh(mesh=None):
    """The mesh the substrate shards over, or None for the local path.
    ``"local"`` mode vetoes everything; an explicit ``mesh`` wins; then the
    registered one; ``"sharded"`` mode builds (once) a mesh over the
    group's ranks, on the devices of the group's backend (NCCL: CUDA,
    gloo: the CPU)."""
    global _MODE_MESH
    if _MODE == "local":
        return None
    if mesh is not None:
        return mesh
    with _MESH_LOCK:
        if _DEFAULT_MESH is not None:
            return _DEFAULT_MESH
        if _MODE == "sharded":
            if _MODE_MESH is None:
                import torch.distributed as dist

                gloo = dist.is_initialized() and dist.get_backend() == "gloo"
                _MODE_MESH = default_mesh(device_type="cpu" if gloo
                                          else None)
            return _MODE_MESH
    return None


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def default_mesh(n_starts=1, device_type=None):
    """A ``(dp=n_starts, sp=rest)`` mesh over the ranks of the initialized
    process group; ``device_type`` None is CUDA."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "default_mesh needs an initialized torch.distributed process "
            "group (parallel.multihost.initialize() brings one up)")
    n = dist.get_world_size()
    n_starts = int(n_starts)
    if n_starts < 1 or n % n_starts:
        raise ValueError(f"{n} devices not divisible by n_starts={n_starts}")
    return init_device_mesh(device_type or "cuda", (n_starts, n // n_starts),
                            mesh_dim_names=(START_AXIS, CAND_AXIS))


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` of ``mesh``."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_rank(mesh, axis) -> int:
    """This process's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def _check_axes(mesh):
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != (START_AXIS, CAND_AXIS):
        raise ValueError(f"a mesh of the substrate has the dimensions "
                         f"{(START_AXIS, CAND_AXIS)}, got {names} (build it "
                         f"with dispatch.default_mesh)")


def _mesh_key(mesh):
    """Cache key of a mesh: dimension names, shape, ranks and device type,
    never ``id(mesh)`` (a collected mesh's id can be reused by a new one)."""
    return (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            mesh.device_type)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's collectives take tensors on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _all_gather(inp, group, n_ranks):
    """One all-gather of ``inp`` from every rank of ``group``:
    ``[n_ranks, *inp.shape]`` in rank order (flat buffers on the wire,
    the layout every backend takes), under the name this torch gives
    it."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    flat = inp.reshape(-1).contiguous()
    out = torch.empty((n_ranks * flat.numel(),), dtype=flat.dtype,
                      device=flat.device)
    gather(out, flat, group=group)
    return out.view((n_ranks,) + tuple(inp.shape))


def gather_lanes(mesh, arrays):
    """Host arrays with a leading lane axis, this rank's share of the runs
    along ``dp``, gathered from every ``dp`` rank in rank order: every rank
    gets the whole set.  Float64 carries them exactly (float32 values, bool
    masks, counts below 2**53)."""
    group = mesh.get_group(START_AXIS)
    w = axis_size(mesh, START_AXIS)
    dev = mesh_device(mesh)
    flat = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                           for a in arrays])
    out = _all_gather(torch.as_tensor(flat, device=dev), group,
                      w).cpu().numpy()
    res, o = [], 0
    for a in arrays:
        a = np.asarray(a)
        k = a.size
        part = out[:, o:o + k].reshape((w * a.shape[0],) + a.shape[1:])
        res.append(part.astype(a.dtype))
        o += k
    return res


# ---------------------------------------------------------------------------
# the sharded kernel
# ---------------------------------------------------------------------------


class ShardedTpeKernel(_tpe._TpeKernel):
    """The TPE step with the candidate axis split over ``mesh["sp"]``.

    The same step as :class:`tpe._TpeKernel` with two hooks replaced:
    :meth:`_cand_slice` keeps this rank's contiguous slice of the
    candidates for scoring (draws, fits and the values stay whole), and
    :meth:`_reduce_stats` turns the slice's argmaxes into global ones with
    one all-gather over the ``sp`` group per step.  Sheets whose scores are
    not one per candidate (the small q-lattice of a quantized column, a
    categorical column's posterior) are computed whole on every rank; only
    the per-candidate lookup is sliced."""

    def __init__(self, cs: CompiledSpace, n_cap, n_cand, lf, mesh,
                 split="sqrt", cat_prior="sqrt", device="cuda",
                 ei_impl="vpu", ei_precision="f32", ei_topm=0,
                 multivariate=False, comp_sampler="icdf"):
        _check_axes(mesh)
        n_shards = axis_size(mesh, CAND_AXIS)
        if n_cand % n_shards:
            raise ValueError(
                f"n_EI_candidates={n_cand} not divisible by the "
                f"{n_shards}-way candidate mesh axis")
        super().__init__(cs, n_cap, n_cand, lf, split, cat_prior, device,
                         ei_impl, ei_precision, ei_topm, multivariate,
                         comp_sampler)
        self.n_shards = n_shards
        self.bind(mesh)

    def bind(self, mesh):
        """Run the collectives on ``mesh`` (a mesh of this kernel's layout:
        the slice stays the same)."""
        self.mesh = mesh
        self.group = mesh.get_group(CAND_AXIS)
        shard = axis_rank(mesh, CAND_AXIS)
        width = self.n_cand // self.n_shards
        self._lo, self._width = shard * width, width

    def _cand_slice(self, x, dim=-1):
        return x.narrow(dim, self._lo, self._width)

    def _reduce_stats(self, stats):
        """One all-gather of every sheet's ``(best bits, global index, tie
        count + 1)`` as int64, reduced on each rank to the winners over all
        candidates."""
        shapes = [bi.shape for bi, _, _ in stats]
        bi = torch.cat([b.reshape(-1) for b, _, _ in stats]) + self._lo
        best = torch.cat([b.reshape(-1) for _, b, _ in stats])
        cnt = torch.cat([t.reshape(-1) for _, _, t in stats]).to(
            torch.int64) + 1
        packed = torch.stack([best.view(torch.int32).to(torch.int64), bi,
                              cnt])
        out = _all_gather(packed, self.group, self.n_shards)
        b_all = out[:, 0].to(torch.int32).view(torch.float32)   # [W, M]
        gbest = torch.amax(b_all, dim=0)
        hit = b_all == gbest
        # NaN scores win an argmax: the first NaN, as torch.argmax.
        first = hit | (torch.isnan(b_all) & torch.isnan(gbest))
        big = torch.full_like(out[:, 1], torch.iinfo(torch.int64).max)
        gidx = torch.amin(torch.where(first, out[:, 1], big), dim=0)
        ties = torch.sum(torch.where(hit, out[:, 2],
                                     torch.zeros_like(out[:, 2])),
                         dim=0) - 1
        res, o = [], 0
        for shape in shapes:
            k = int(np.prod(shape, dtype=np.int64))
            res.append((gidx[o:o + k].reshape(shape),
                        gbest[o:o + k].reshape(shape),
                        ties[o:o + k].to(torch.int32).reshape(shape)))
            o += k
        return res

    def _next_bucket(self):
        return _kernel(self.cs, self.n_cap * 2, self.n_cand, self.lf,
                       self.device, self.lowering, self.mesh)


# ---------------------------------------------------------------------------
# kernel acquisition
# ---------------------------------------------------------------------------


def get_kernel(cs: CompiledSpace, n_cap: int, n_cand: int, lf: int,
               split: str = "sqrt", cat_prior: str = "sqrt", device="cuda",
               ei_impl: str = "vpu", ei_precision: str = "f32",
               ei_topm: int = 0, multivariate: bool = False,
               comp_sampler: str = "icdf", mesh=None, strict: bool = False):
    """The one kernel-acquisition point of every suggest path.

    ``mesh=None`` is exactly ``tpe.get_kernel``.  With a mesh, a
    :class:`ShardedTpeKernel` from ``cs._dispatch_kernels``, keyed by the
    local key plus ``("mesh",) + _mesh_key(mesh)``; hits and misses feed
    ``kernel_cache_event``.  A candidate count the ``sp`` axis does not
    divide raises ``ValueError`` when ``strict``; otherwise the local
    kernel serves and ``dispatch.fallback_indivisible`` counts it (an
    ambient mesh never turns a working configuration into an error)."""
    return _kernel(cs, n_cap, n_cand, lf, torch.device(device),
                   _tpe._lowering(split, cat_prior, ei_impl, ei_precision,
                                  ei_topm, multivariate, comp_sampler),
                   mesh, strict)


def _kernel(cs, n_cap, n_cand, lf, device, lowering, mesh=None,
            strict=False):
    """:func:`get_kernel` for a checked ``lowering`` (``tpe._lowering``)."""
    if mesh is None:
        return _tpe._kernel(cs, n_cap, n_cand, lf, device, lowering)
    _check_axes(mesh)
    n_shards = axis_size(mesh, CAND_AXIS)
    if n_cand % n_shards:
        if strict:
            raise ValueError(
                f"n_EI_candidates={n_cand} not divisible by the "
                f"{n_shards}-way candidate mesh axis")
        _metrics_registry().counter("dispatch.fallback_indivisible").inc()
        return _tpe._kernel(cs, n_cap, n_cand, lf, device, lowering)
    key = ((n_cap, n_cand, lf, str(device)) + lowering
           + (("mesh",) + _mesh_key(mesh),))
    kern = _tpe._cached_kernel(
        "_dispatch_kernels", "tpe_sharded", cs, key,
        lambda: ShardedTpeKernel(cs, n_cap, n_cand, lf, mesh, *lowering[:2],
                                 device, *lowering[2:]))
    if kern.mesh is not mesh:
        kern.bind(mesh)
    return kern


# ---------------------------------------------------------------------------
# the substrate dispatch (sharded twin of tpe.suggest_dispatch)
# ---------------------------------------------------------------------------


def suggest_dispatch(new_ids, domain, trials, seed, mesh=None, strict=False,
                     prior_weight=_tpe._default_prior_weight,
                     n_startup_jobs=_tpe._default_n_startup_jobs,
                     n_EI_candidates=_tpe._default_n_EI_candidates,
                     gamma=_tpe._default_gamma,
                     linear_forgetting=_tpe._default_linear_forgetting,
                     split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                     ei_precision="f32", ei_topm=0, resident=True,
                     multivariate=False, startup=None, comp_sampler="icdf",
                     verbose=True, noise=None):
    """Sharded twin of :func:`tpe.suggest_dispatch`: the same startup,
    fantasies, bucket, prewarm, resident ring and handle, with the kernel
    from :func:`get_kernel` (``mesh`` resolved by :func:`active_mesh`).
    Counts ``dispatch.sharded`` or ``dispatch.local``.  ``noise``: the
    step's uniforms (CPU tests), as ``tpe._dispatch_with`` takes them."""
    mesh = active_mesh(mesh)
    if mesh is None and noise is None:
        return _tpe.suggest_dispatch(
            new_ids, domain, trials, seed, prior_weight=prior_weight,
            n_startup_jobs=n_startup_jobs, n_EI_candidates=n_EI_candidates,
            gamma=gamma, linear_forgetting=linear_forgetting, split=split,
            cat_prior=cat_prior, ei_impl=ei_impl, ei_precision=ei_precision,
            ei_topm=ei_topm, resident=resident, multivariate=multivariate,
            startup=startup, comp_sampler=comp_sampler, verbose=verbose)
    lowering = _tpe._lowering(split, cat_prior, ei_impl, ei_precision,
                              ei_topm, multivariate, comp_sampler)
    dev = resolve_device(domain.cs.device)
    n_cand, lf = int(n_EI_candidates), int(linear_forgetting)
    reg = _metrics_registry()

    def acquire(n_cap):
        kern = _kernel(domain.cs, n_cap, n_cand, lf, dev, lowering, mesh,
                       strict)
        sharded = isinstance(kern, ShardedTpeKernel)
        reg.counter("dispatch.sharded" if sharded else "dispatch.local").inc()
        return kern

    return _tpe._dispatch_with(acquire, new_ids, domain, trials, seed,
                               prior_weight, n_startup_jobs, gamma,
                               resident, startup, noise=noise)


# ---------------------------------------------------------------------------
# multi-start: K posteriors, one per lane, lanes over dp
# ---------------------------------------------------------------------------


def _gamma_spread(gamma, n_starts):
    """Per-start γ ladder ``γ·2**linspace(-1, 1, K)`` clipped to
    ``[0.05, 0.75]`` (float32); K = 1 is the base γ."""
    if n_starts == 1:
        return np.asarray([gamma], np.float32)
    return np.clip(gamma * np.exp2(np.linspace(-1.0, 1.0, n_starts)),
                   0.05, 0.75).astype(np.float32)


def _start_seeds(seed, n_starts):
    """Start ``k``'s generator seed: a function of ``(seed, k)`` only, so
    a start draws the same whatever K and whichever rank runs it."""
    return [int(np.random.SeedSequence([int(seed) % (2 ** 32), k])
                .generate_state(1)[0]) for k in range(n_starts)]


def multi_start_suggest(new_ids, domain, trials, seed, mesh=None,
                        prior_weight=_tpe._default_prior_weight,
                        n_startup_jobs=_tpe._default_n_startup_jobs,
                        n_EI_candidates=_tpe._default_n_EI_candidates,
                        gamma=_tpe._default_gamma,
                        linear_forgetting=_tpe._default_linear_forgetting,
                        split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                        ei_precision="f32", ei_topm=0, resident=True,
                        multivariate=False, startup=None,
                        comp_sampler="icdf", noise=None):
    """``algo=`` callable proposing ``len(new_ids)`` configurations from
    one step over K lanes (``tpe._TpeKernel._suggest_lanes``, one EI launch
    for all starts): start ``k`` reads the same history with its own
    generator (:func:`_start_seeds`) and its own γ from the
    :func:`_gamma_spread` ladder, the parallel answer to batch collapse.
    K is ``len(new_ids)`` rounded up to a multiple of ``mesh["dp"]``; each
    ``dp`` rank runs its K/dp lanes and the rows are all-gathered.  With
    no mesh, one rank on this process's device runs all K.  ``noise``:
    one :meth:`~tpe._TpeKernel.draw_noise` dict per start (CPU tests).
    Use with ``fmin(..., max_queue_len=K)``."""
    cs = domain.cs
    exp_key = getattr(trials, "exp_key", None)
    if cs.n_params == 0:
        return rand.suggest(new_ids, domain, trials, seed)
    h = trials.history(cs)
    if int(h["ok"].sum()) < n_startup_jobs:
        v, a = _tpe._startup_batch(startup, new_ids, domain, trials, seed)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
            a = cs.active_mask_host(v)
        return base.docs_from_samples(cs, new_ids, np.asarray(v),
                                      np.asarray(a), exp_key=exp_key)
    dev = resolve_device(cs.device)
    n = len(new_ids)
    if resident:
        fant = _tpe._inflight_fantasy_rows(h, trials, cs)
        n_rows = h["vals"].shape[0] + (len(fant[0]) if fant else 0)
    else:
        h = _tpe._with_inflight_fantasies(h, trials, cs)
        n_rows = h["vals"].shape[0]
    n_dp = 1 if mesh is None else axis_size(mesh, START_AXIS)
    r = 0 if mesh is None else axis_rank(mesh, START_AXIS)
    n_starts = -(-n // n_dp) * n_dp
    share = n_starts // n_dp
    lanes = range(r * share, (r + 1) * share)
    kern = _tpe.get_kernel(cs, _tpe._bucket(n_rows), int(n_EI_candidates),
                           int(linear_forgetting), split, cat_prior, dev,
                           ei_impl, ei_precision, ei_topm, multivariate,
                           comp_sampler)
    kern.check_lanes(share)
    if resident:
        from . import history

        hist = history.device_history(trials, cs, h, kern.n_cap,
                                      fantasies=fant, device=dev)
    else:
        hist = [torch.as_tensor(a, device=dev)
                for a in _tpe._padded_history(h, kern.n_cap)]
    hist = [t[None].expand(share, *t.shape) for t in hist]
    gammas = torch.as_tensor(_gamma_spread(gamma, n_starts)[r * share:
                                                            (r + 1) * share],
                             device=dev)
    seeds = _start_seeds(seed, n_starts)
    if noise is not None:
        if len(noise) != n_starts:
            raise ValueError(f"{len(noise)} noise dicts for {n_starts} "
                             f"starts")
        gens, nz = None, _tpe.stack_noise([noise[k] for k in lanes])
    else:
        gens, nz = [make_generator(dev, seeds[k]) for k in lanes], None
    rows, _, _, _ = kern._suggest_lanes(*hist, gammas, prior_weight,
                                        generators=gens, noise=nz)
    if n_dp > 1:
        rows = _all_gather(rows, mesh.get_group(START_AXIS),
                           n_dp).reshape(n_starts, -1)
    rows = rows.cpu().numpy()[:n]
    return base.docs_from_samples(cs, new_ids, rows,
                                  cs.active_mask_host(rows), exp_key=exp_key)

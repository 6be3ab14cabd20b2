"""Many processes: ``torch.distributed``, the mesh and a shared trial store.

Counterpart of ``hyperopt_tpu/parallel/multihost.py``.  Two tiers:

* **within the mesh**: :func:`initialize` brings up ``torch.distributed``
  (NCCL for CUDA, gloo for the CPU; never one in place of the other),
  builds the ``(dp, sp)`` mesh over the group's ranks and registers it with
  ``dispatch.set_default_mesh``, so that from then on every
  ``tpe.suggest`` of the process is the sharded, collective step;
* **across processes**: a shared :class:`~.filestore.FileTrials`
  directory, where :func:`run_driver` suggests and enqueues and
  :func:`run_worker` (or ``hyperopt-tpu-torch-worker`` processes anywhere
  the directory reaches) evaluates.

The JAX package also routes an ``http(s)://`` store through its network
store; that belongs to the netstore slice of the port, and such a
``store_root`` raises ``NotImplementedError`` here.

Typical use (the same program on every host)::

    from hyperopt_tpu_torch.parallel import multihost
    mesh = multihost.initialize()          # a world of one without arguments
    if multihost.is_coordinator():
        multihost.run_driver(fn, space, store_root="/mnt/shared/exp",
                             max_evals=1000)
    else:
        multihost.run_worker(store_root="/mnt/shared/exp")
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_NOT_PORTED = ("{what} with a service URL store_root is not ported yet: it "
               "belongs to the netstore slice (parallel/netstore.py, "
               "ROADMAP.md Queue 1)")


def _is_service_url(store_root: str) -> bool:
    return str(store_root).startswith(("http://", "https://"))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None):
    """Bring up ``torch.distributed`` and register the ``(dp=1, sp=W)``
    mesh over its ranks with the dispatch substrate; returns the mesh.

    ``device`` (None: CUDA) picks the backend: NCCL for CUDA, gloo for
    the CPU.  ``init_method`` (e.g. ``"tcp://host:port"``), ``world_size``
    and ``rank`` are ``init_process_group``'s; without them the world is
    this process alone (a ``HashStore``).  A process group that is up
    already is kept.  On CUDA the process's device is ``cuda:<rank>``
    modulo the visible cards, and one warm-up all-gather builds the NCCL
    communicator (a CUDA graph cannot capture its setup)."""
    import torch.distributed as dist

    from .. import dispatch
    from ..space import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            local = (int(rank or 0) if dev.index is None else dev.index) \
                % torch.cuda.device_count()
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        if init_method is None and (world_size or 1) == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank, **kw)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"torch.distributed is up with the "
                           f"{dist.get_backend()} backend; {dev.type} needs "
                           f"{backend}")
    mesh = dispatch.default_mesh(device_type=dev.type)
    # Warm-up collective: NCCL builds its communicator on the first one.
    dispatch._all_gather(torch.zeros(1, device=dispatch.mesh_device(mesh)),
                         mesh.get_group(dispatch.CAND_AXIS),
                         dispatch.axis_size(mesh, dispatch.CAND_AXIS))
    return dispatch.set_default_mesh(mesh)


def is_coordinator() -> bool:
    """True on rank 0 (and in a process without a group)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def run_driver(fn, space, store_root: str, max_evals: int, mesh=None,
               exp_key: str = "default", n_EI_candidates: int = 4096,
               stale_timeout: float = 600.0, **fmin_kwargs):
    """Coordinator role: the sharded TPE suggest and the enqueue into a
    :class:`~.filestore.FileTrials` at ``store_root``; workers evaluate,
    and stale trials of dead workers are requeued every loop.

    ``mesh`` defaults to this process's one-rank mesh (the registered one,
    else one over a world of one).  A mesh of more than one rank raises
    ``ValueError``: the sharded suggest is a collective that the worker
    ranks never enter."""
    from functools import partial

    from .. import dispatch
    from ..base import Domain
    from ..fmin import fmin
    from .filestore import FileTrials
    from .sharded import sharded_suggest

    if _is_service_url(store_root):
        raise NotImplementedError(_NOT_PORTED.format(what="run_driver"))
    if mesh is None:
        mesh = dispatch.active_mesh()
    if mesh is None:
        mesh = initialize(device=fmin_kwargs.get("device"))
    if mesh.mesh.numel() > 1:
        raise ValueError(
            f"run_driver needs a mesh of one rank, got {tuple(mesh.shape)}: "
            f"the sharded suggest is a collective that worker ranks never "
            f"enter, so the driver would wait on them forever")
    trials = FileTrials(store_root, exp_key=exp_key)
    # Ship the Domain to the workers (fmin runs with allow_trials_fmin=False
    # below, so the store's own fmin does not).
    trials.save_domain(Domain(fn, space))
    algo = partial(sharded_suggest, mesh=mesh,
                   n_EI_candidates=n_EI_candidates)
    base_early_stop = fmin_kwargs.pop("early_stop_fn", None)

    def early_stop(trials_, *args):
        trials_.requeue_stale(stale_timeout)
        if base_early_stop is not None:
            return base_early_stop(trials_, *args)
        return False, args

    return fmin(fn, space, algo=algo, max_evals=max_evals, trials=trials,
                early_stop_fn=early_stop, allow_trials_fmin=False,
                **fmin_kwargs)


def run_worker(store_root: str, exp_key: str = "default", **worker_kwargs):
    """Worker role: evaluate trials from the store at ``store_root`` until
    idle (:class:`~.filestore.FileWorker`); returns the trials done."""
    from .filestore import FileWorker

    if _is_service_url(store_root):
        raise NotImplementedError(_NOT_PORTED.format(what="run_worker"))
    n = FileWorker(store_root, exp_key=exp_key, **worker_kwargs).run()
    logger.info("multihost worker done: %d trials", n)
    return n

"""Random-search suggest algorithm (counterpart of ``hyperopt_tpu/rand.py``).

All ``len(new_ids)`` configurations are drawn in one batched
:meth:`CompiledSpace.sample` call on the space's device, from a
``torch.Generator`` seeded with the suggest seed.
"""

from __future__ import annotations

from . import base
from .space import make_generator, resolve_device


def suggest(new_ids, domain, trials, seed):
    """Sample the prior: one configuration per new trial id."""
    if len(new_ids) == 0:
        return []
    vals, _ = suggest_batch(new_ids, domain, trials, seed)
    # Fetch only the values; the mask is a host function of them.
    vals = vals.cpu().numpy()
    return base.docs_from_samples(domain.cs, new_ids,
                                  vals, domain.cs.active_mask_host(vals),
                                  exp_key=getattr(trials, "exp_key", None))


def suggest_batch(new_ids, domain, trials, seed):
    """Raw ``(vals[n, P], active[n, P])`` tensors on the space's device."""
    dev = resolve_device(domain.cs.device)
    gen = make_generator(dev, int(seed) % (2 ** 32))
    return domain.cs.sample(len(new_ids), generator=gen, device=dev)


#: The names the backend registry (``backends/contract.py``) resolves
#: through.
BACKENDS = {"rand": suggest, "random": suggest}

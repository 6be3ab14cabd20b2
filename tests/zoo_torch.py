"""The domain zoo (``tests/zoo.py``) with spaces built by the port's ``hp``.

The domain factories of ``zoo.py`` run unchanged with ``zoo.hp``
pointed at the port's module and the JAX compile of
``ZooDomain.__post_init__`` left out, so each domain has the same
labels, distributions, objective, thresholds and budget as its JAX
twin."""

import zoo
from hyperopt_tpu_torch import hp as _hp


def _build():
    saved_hp, saved_post = zoo.hp, zoo.ZooDomain.__post_init__
    zoo.hp = _hp
    zoo.ZooDomain.__post_init__ = lambda self: None
    try:
        return {name: getattr(zoo, f"_{name}")() for name in zoo.ZOO}
    finally:
        zoo.hp, zoo.ZooDomain.__post_init__ = saved_hp, saved_post


ZOO = _build()
CONVERGENCE_DOMAINS = zoo.CONVERGENCE_DOMAINS

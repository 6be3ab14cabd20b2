"""Pluggable suggest backends: the contract, the registry, and the
model-based heads outside the Parzen family (``gp``, ``es``).

Counterpart of ``hyperopt_tpu/backends``.  Importing this package imports
no head: builtin heads load on their first :func:`resolve`.  See
:mod:`hyperopt_tpu_torch.backends.contract` for the protocol.
"""

from .contract import (  # noqa: F401
    UnknownBackend,
    names,
    register_backend,
    resolve,
    run_conformance,
)

"""The ``scope`` expression namespace: deterministic ops over ``hp`` leaves.

Counterpart of ``hyperopt_tpu/scope.py``; the composition layer behind
idioms like::

    scope.int(hp.quniform("n_layers", 1, 64, 1))
    scope.switch(hp.randint("act", 3), "relu", "tanh", "gelu")
    hp.uniform("frac", 0, 1) * scope.len(some_list)

Expressions are decode-time host transforms over the compiled sampler's
raw draws, so they cost nothing on the suggest path.

Extension point::

    from hyperopt_tpu_torch import scope

    @scope.define
    def megabytes(x):
        return x * 1024 * 1024

    space = {"cache": scope.megabytes(hp.quniform("mb", 1, 512, 1))}
"""

from __future__ import annotations

from .space import Apply, _SCOPE_IMPLS, define_op


class _OpBuilder:
    """Callable that builds an :class:`~hyperopt_tpu_torch.space.Apply` node."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args):
        return Apply(self.name, args)

    def __repr__(self):
        return f"scope.{self.name}"


class _Scope:
    """Attribute access builds expression nodes: ``scope.int(x)`` →
    ``Apply("int", (x,))``.  ``@scope.define`` registers new ops."""

    def __getattr__(self, name):
        if name == "define":
            return self._define
        if name in _SCOPE_IMPLS:
            return _OpBuilder(name)
        raise AttributeError(
            f"scope has no op {name!r}; register it with @scope.define")

    @staticmethod
    def _define(fn):
        """Decorator: register ``fn`` as a scope op and return its builder.

        The decorated name then works both as ``scope.<name>(...)`` and as
        the returned callable.
        """
        define_op(fn.__name__, fn)
        return _OpBuilder(fn.__name__)


scope = _Scope()

"""The flagship space of ``flagship.py``, with its objective also as a torch
function of the card, for device mode and the fleet.

``device_objective(p)`` takes device mode's ``{label: 0-d float32
tensor}`` and adds the products ``p[u]·p[u]`` of the uniform columns one
at a time in float32, in the order of :func:`objective_labels` (``u0``,
``u1``, ...): the same sum the float64 ``objective`` computes, rounded at
each product and each addition.
"""

from portbench.spaces.flagship import build, objective, objective_labels

__all__ = ["build", "device_objective", "objective", "objective_labels"]


def device_objective(p):
    acc = None
    i = 0
    while f"u{i}" in p:
        x = p[f"u{i}"]
        acc = x * x if acc is None else acc + x * x
        i += 1
    return acc

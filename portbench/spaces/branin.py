"""The two-dimensional Branin function, hyperopt's own first example and
the project's BASELINE.json config 1 (its suite's ``bench_1_branin``):
``x`` uniform on [-5, 10], ``y`` uniform on [0, 15] (``n_dims`` is 2).  ``hp`` is the module that builds the space: the
program's ``hp`` for the system under test, or the reference's plain
stand-in (``reference/space.py``).
"""

import math


def build(hp, n_dims):
    return {"x": hp.uniform("x", -5.0, 10.0), "y": hp.uniform("y", 0.0, 15.0)}


def objective_labels(n_dims):
    """The columns the objective reads."""
    return ["x", "y"]


def objective(v):
    """Branin at ``v`` (``{label: float}``), in float64."""
    x, y = v["x"], v["y"]
    b, c = 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
    t = 1.0 / (8 * math.pi)
    return ((y - b * x ** 2 + c * x - 6.0) ** 2
            + 10.0 * (1 - t) * math.cos(x) + 10.0)

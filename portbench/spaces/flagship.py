"""The mixed search space of the project's north-star benchmark.

``n_dims // 5`` each of uniform, loguniform, quniform (a lattice of 11
points), normal and 4-way choice columns, and a conditional branch: a
2-way choice whose first option holds a loguniform and whose second a
uniformint (``n_dims + 3`` parameters).  ``hp`` is the module that builds
the space: the program's ``hp`` for the system under test, or the
reference's plain stand-in (``reference/space.py``).
"""


def build(hp, n_dims):
    space = {}
    for i in range(n_dims // 5):
        space[f"u{i}"] = hp.uniform(f"u{i}", -5.0, 5.0)
        space[f"lu{i}"] = hp.loguniform(f"lu{i}", -4.0, 2.0)
        space[f"q{i}"] = hp.quniform(f"q{i}", 0.0, 20.0, 2.0)
        space[f"n{i}"] = hp.normal(f"n{i}", 0.0, 2.0)
        space[f"c{i}"] = hp.choice(f"c{i}", [0, 1, 2, 3])
    space["branch"] = hp.choice("branch", [
        {"kind": "a", "lr": hp.loguniform("lr", -6.0, 0.0)},
        {"kind": "b", "depth": hp.uniformint("depth", 1, 8)},
    ])
    return space


def objective_labels(n_dims):
    """The columns the objective reads: the uniform ones."""
    return [f"u{i}" for i in range(n_dims // 5)]


def objective(v):
    """The sum of the squares of ``v``'s values (``{label: float}``, the
    uniform columns), in float64."""
    acc = 0.0
    for x in v.values():
        acc = acc + x * x
    return acc
